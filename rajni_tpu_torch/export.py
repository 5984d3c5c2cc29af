"""Serving artifacts (port of ``rajni_tpu/export.py``).

:func:`export_model` writes the pruned forward's whole configuration into
one file that a serving process turns back into a callable with
:func:`load_exported`::

    from rajni_tpu_torch.export import export_model, load_exported

    export_model("vit_b16.rajni", params, config, schedule, batch=[8, 32, 256])
    ...
    serve_fn = load_exported("vit_b16.rajni")      # on the card
    logits = serve_fn(images)                      # [n, H, W, 3] -> [n, 1000]

The artifact is this package's own container, not StableHLO: PyTorch has no
counterpart of a ``jax.export`` program, and ``torch.export`` cannot trace
the kernels' ``ctypes`` launches. Its layout:

  * the magic line ``RAJNI-TORCH\\x01``;
  * a 4-byte big-endian length and a JSON header: the config (every field,
    so adapted variants survive), the normalized schedule, the dtype,
    ``batch`` (an int, ``"dynamic"`` or the ascending bucket list), the
    route resolved for each bucket, the target ``platform`` (``"cuda"`` or
    ``"cpu"``) and the static ``act_scales`` (JAX's JSON object) when they
    are baked;
  * the params once, in the msgpack of :mod:`.params.io` (the JAX tree's
    layout, int8 records included), however many buckets there are.

``impl="auto"`` resolves against the target ``platform``, not the exporting
host (:func:`.models.vit.resolve_route`), so a host without a card writes a
``cuda`` artifact that routes the kernels. The loader refuses what it cannot
run as written and never falls back: another platform than the device's, a
JAX artifact, or a ``cuda`` route whose kernels do not take the config.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from collections import namedtuple

import torch

from .models.vit import (
    ViTConfig,
    cuda_kernels_take,
    params_quantized,
    resolve_route,
    route_line,
    tree_to,
)
from .models.wrapper import RAJNIViT
from .params.from_jax import params_from_numpy, params_to_numpy
from .params.io import _packb, _restore_blocks, _unpackb
from .quant import ActScales
from .utils.schedule import normalize_schedule, schedule_to_dict
from .utils.timing import require_device

MAGIC = b"RAJNI-TORCH\x01"
FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
# the JAX package's multi-bucket container (rajni_tpu/export.py:_BUCKET_MAGIC)
_JAX_BUCKET_MAGIC = b"RAJNI-BUCKETS\x01"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: a loaded artifact's input: ``(batch, H, W, 3)`` (batch None when dynamic)
InputSpec = namedtuple("InputSpec", ["shape", "dtype"])


def _batch_form(batch) -> int | str | list[int]:
    """``batch`` checked as JAX checks it: a positive int, ``"dynamic"``, or
    a list of positive ints (returned sorted, without repeats)."""
    if isinstance(batch, (list, tuple)):
        buckets = sorted(set(int(b) for b in batch))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket batches must be positive ints: {batch}")
        return buckets
    if batch == "dynamic":
        return batch
    if isinstance(batch, bool) or not isinstance(batch, int) or batch < 1:
        raise ValueError(f"batch must be an int, 'dynamic' or a list of ints, got {batch!r}")
    return batch


def export_model(
    path: str,
    params,
    config: ViTConfig,
    schedule=None,
    batch: int | str | list | tuple = 256,
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
    platform: str = "cuda",
    act_scales: ActScales | None = None,
) -> dict:
    """Write the artifact of ``params`` (the port's dictionary, int8 records
    allowed) under ``config``/``schedule`` to ``path``; return its header.

    ``batch`` is a fixed batch (the artifact takes exactly that many
    images), ``"dynamic"`` (any batch, run as it comes), or a bucket list
    ``[8, 32, 256]`` (each request padded with zero images to the smallest
    sufficient bucket, chunked by the largest past it). JAX refuses
    ``impl="pallas"`` with ``"dynamic"``, because a Pallas grid is static per
    batch; the port's kernels take any batch, so a dynamic artifact runs
    them too. ``impl`` resolves against ``platform`` (``"auto"`` is
    ``"cuda"`` for a ``cuda`` target, demoted where the kernels do not take
    the config or dtype); ``impl="cuda"`` cannot target the CPU.
    ``act_scales`` (int8 params) bakes calibrated static scales, which apply
    on the kernel route only.
    """
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    batch = _batch_form(batch)
    schedule = normalize_schedule(schedule, config.depth)
    if impl == "cuda" and platform != "cuda":
        raise ValueError(f"impl='cuda' cannot target platform={platform!r}: the kernels are "
                         "CUDA programs; export with --kernels torch for CPU serving")
    dtype_name = next((k for k, v in _DTYPES.items() if v == dtype), None)
    if dtype_name is None:
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
    route, reason = resolve_route(impl, config, dtype, platform, params_quantized(params))
    if act_scales is not None and route == "torch":
        print("WARNING: act_scales only apply to the cuda kernel route; this torch-route "
              "artifact stays fully dynamic")
    sizes = batch if isinstance(batch, list) else [batch]
    header = {
        "format": FORMAT_VERSION,
        "config": dataclasses.asdict(config),
        "schedule": {str(k): v for k, v in schedule_to_dict(schedule).items()},
        "dtype": dtype_name,
        "batch": batch,
        "routes": {str(b): {"impl": route, "reason": reason} for b in sizes},
        "platform": platform,
        "act_scales": None if act_scales is None else act_scales.to_dict(),
    }
    head = json.dumps(header).encode()
    body = _packb(params_to_numpy(tree_to(params, dtype=dtype, device="cpu")))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack(">I", len(head)))
        f.write(head)
        f.write(body)
    os.replace(tmp, path)  # a reader never sees a partial artifact
    return header


def read_header(raw: bytes, path: str = "artifact") -> tuple[dict, int]:
    """``(header, offset of the params)`` of an artifact's bytes; a JAX
    artifact, or any other file, raises with what it is."""
    if raw.startswith(_JAX_BUCKET_MAGIC):
        raise ValueError(
            f"{path} is a multi-bucket artifact of the JAX package (rajni_tpu.export's "
            "RAJNI-BUCKETS container of jax.export programs), which this package cannot run: "
            "export with python -m rajni_tpu_torch.export")
    if not raw.startswith(MAGIC):
        raise ValueError(
            f"{path} is not a rajni_tpu_torch artifact (no {MAGIC!r} header). A headerless file "
            "is what rajni_tpu.export writes for one batch (a serialized jax.export StableHLO "
            "program), which this package cannot run: export with python -m "
            "rajni_tpu_torch.export")
    off = len(MAGIC)
    (n,) = struct.unpack(">I", raw[off:off + 4])
    header = json.loads(raw[off + 4:off + 4 + n].decode())
    if header.get("format") != FORMAT_VERSION:
        raise ValueError(f"{path}: artifact format {header.get('format')} != {FORMAT_VERSION}")
    return header, off + 4 + n


def run_padded(fn, x: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """``fn`` over ``x`` in chunks of the largest of the ascending
    ``sizes``, each chunk padded with zero images to the smallest size that
    holds it; the logits are sliced back to ``x``'s rows. The one padding
    rule of the artifacts, the server and ``run.py --artifact``."""
    outs = []
    for i in range(0, x.shape[0], sizes[-1]):
        chunk = x[i:i + sizes[-1]]
        b = chunk.shape[0]
        cap = next(c for c in sizes if b <= c)
        if b < cap:
            chunk = torch.cat([chunk, chunk.new_zeros((cap - b,) + tuple(chunk.shape[1:]))])
        outs.append(fn(chunk)[:b])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def load_exported(path: str, device="cuda"):
    """An artifact of :func:`export_model` as a callable ``images ->
    logits`` on ``device`` (which must be the artifact's platform).

    The callable takes ``[n, H, W, 3]`` images (a tensor or an array,
    moved to the device in the artifact's dtype) and returns ``[n, classes]``
    logits on the device. Its attributes: ``input_spec`` (shape and dtype;
    the batch is the largest bucket, the fixed batch, or None when
    dynamic), ``dynamic_batch``, ``buckets`` (the ascending list, or None),
    ``route`` (the ``route:`` line), ``config``, ``schedule``, ``device``,
    and ``any_batch``, the same callable at any batch (see
    :func:`run_padded`).
    A multi-bucket artifact pads each request with zero images to the
    smallest sufficient bucket (chunked by the largest past it) and slices
    the logits back; a fixed artifact takes exactly its batch; a dynamic one
    any batch. The weights are one copy, whatever the buckets.
    """
    with open(path, "rb") as f:
        raw = f.read()
    header, off = read_header(raw, path)
    device = require_device(device)
    if header["platform"] != device.type:
        raise ValueError(f"{path} was exported for platform {header['platform']!r}, not "
                         f"{device.type!r}: export it again with --platform {device.type}")
    config = ViTConfig(**header["config"])
    schedule = normalize_schedule(header["schedule"], config.depth)
    dtype = _DTYPES[header["dtype"]]
    impls = {r["impl"] for r in header["routes"].values()}
    if len(impls) != 1:
        raise ValueError(f"{path}: the buckets' routes differ: {header['routes']}")
    impl = impls.pop()
    params = params_from_numpy(_restore_blocks(_unpackb(raw[off:])), dtype=dtype, device=device)
    del raw
    if impl == "cuda" and device.type == "cuda":
        ok, why = cuda_kernels_take(config, dtype, params_quantized(params))
        if not ok:
            raise ValueError(f"{path}: its route is cuda, but the kernels do not take it ({why})")
        from .kernels.build import _library

        _library()  # built and loaded now, not at the first request
    act_scales = header["act_scales"]
    model = RAJNIViT(config, schedule, params=params, dtype=dtype, kernels=impl, device=device,
                     act_scales=None if act_scales is None else ActScales.from_dict(act_scales))
    batch = header["batch"]
    buckets = batch if isinstance(batch, list) else None
    fixed = batch if isinstance(batch, int) else None
    image = (config.img_size, config.img_size, config.in_chans)

    def prepare(images) -> torch.Tensor:
        x = torch.as_tensor(images).to(device=device, dtype=dtype)
        if tuple(x.shape[1:]) != image:
            raise ValueError(f"images {tuple(x.shape)} do not match the artifact's "
                             f"[n, {', '.join(map(str, image))}]")
        return x

    @torch.no_grad()
    def serve(images) -> torch.Tensor:
        x = prepare(images)
        if buckets is not None:
            return run_padded(model, x, buckets)
        if fixed is not None and x.shape[0] != fixed:
            raise ValueError(f"this artifact takes exactly {fixed} images, got {x.shape[0]}")
        return model(x)

    @torch.no_grad()
    def any_batch(images) -> torch.Tensor:
        """``serve`` at any batch: a fixed artifact's requests padded and
        chunked to its batch; the other forms are ``serve`` itself."""
        if fixed is None:
            return serve(images)
        return run_padded(model, prepare(images), [fixed])

    serve.input_spec = InputSpec((buckets[-1] if buckets else fixed,) + image, dtype)
    serve.dynamic_batch = batch == "dynamic"
    serve.buckets = None if buckets is None else list(buckets)
    serve.route = route_line(impl, next(iter(header["routes"].values()))["reason"])
    serve.config, serve.schedule, serve.device = config, schedule, device
    serve.model = model
    serve.any_batch = any_batch
    return serve


def parse_batch(text: str) -> int | str | list[int]:
    """The CLI's ``--batch``: an int, ``dynamic``, or a comma list."""
    if text == "dynamic":
        return text
    if "," in text:
        return [int(x) for x in text.split(",") if x]
    return int(text)


def main(argv=None) -> None:
    """CLI: ``python -m rajni_tpu_torch.export ckpt.msgpack model.rajni
    --model vit_base_patch16_224 --schedule sched.json --batch 8,32,256``."""
    import argparse

    from .models.vit import adapt_config_to_params, get_config
    from .params.io import load_checkpoint_auto
    from .quant import quantize_params
    from .utils.schedule import load_schedule

    p = argparse.ArgumentParser("rajni-tpu-torch serving export")
    p.add_argument("checkpoint", help="params: msgpack of either package, or a timm "
                                      ".pth/.pt/.bin state_dict")
    p.add_argument("output", help="output artifact path (.rajni)")
    p.add_argument("--model", default="vit_base_patch16_224")
    p.add_argument("--schedule", default=None, help="pruning schedule JSON")
    p.add_argument("--batch", default="256",
                   help="fixed batch size; 'dynamic' for any batch; or a comma list "
                        "'8,32,256' for a multi-bucket artifact (requests pad to the "
                        "smallest sufficient bucket)")
    p.add_argument("--dtype", default="bfloat16", choices=list(_DTYPES))
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the weights before export")
    p.add_argument("--act_scales", default=None, metavar="FILE",
                   help="with --quantize: calibrated static activation scales JSON "
                        "(rajni_tpu_torch.run --save_scales), baked into the artifact")
    p.add_argument("--kernels", default="auto", choices=["auto", "torch", "cuda"])
    p.add_argument("--platform", default="cuda", choices=list(PLATFORMS),
                   help="the platform the artifact is loaded on")
    args = p.parse_args(argv)

    config = get_config(args.model)
    dtype = _DTYPES[args.dtype]
    params = load_checkpoint_auto(args.checkpoint, args.model, dtype=dtype)
    # extended-variant checkpoints carry their semantics in the tree, not the name
    adapted = adapt_config_to_params(config, params)
    if adapted != config:
        config = adapted
        print("Adapted config to checkpoint variant: "
              f"qk_norm={config.qk_norm} global_pool={config.global_pool} "
              f"reg_tokens={config.reg_tokens} distilled={config.distilled} "
              f"no_embed_class={config.no_embed_class}")
    act_scales = None
    if args.act_scales:
        if not args.quantize:
            raise ValueError("--act_scales requires --quantize")
        act_scales = ActScales.load(args.act_scales)
    if args.quantize:
        params = quantize_params(params)
    schedule = load_schedule(args.schedule, config.depth) if args.schedule else None
    header = export_model(args.output, params, config, schedule, parse_batch(args.batch), dtype,
                          args.kernels, args.platform, act_scales=act_scales)
    route = next(iter(header["routes"].values()))
    print(f"{route_line(route['impl'], route['reason'])} (platform {args.platform})")
    print(f"exported {args.model} (batch {args.batch}, "
          f"{'int8' if args.quantize else args.dtype}) -> {args.output} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
