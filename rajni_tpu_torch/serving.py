"""Serving: dynamic request batching over an exported artifact (port of
``rajni_tpu/serving.py``).

* :class:`BatchingEngine`: a request queue and one worker thread.
  :meth:`~BatchingEngine.submit` takes one image and returns a
  ``concurrent.futures.Future`` of its logits row; the worker gathers what
  is queued within ``max_delay_ms`` of the oldest request (up to
  ``max_batch``) into one forward on the device.
* :func:`make_server` and ``python -m rajni_tpu_torch.serving``: a stdlib
  threaded HTTP front end (``POST /v1/classify`` with an image body); each
  connection thread waits on its future, so concurrent connections share
  device batches. ``GET /v1/stats`` gives the request rate, the mean batch
  and the latency percentiles.

The engine takes the three artifact forms of :func:`.export.load_exported`
(buckets: batches up to the largest bucket, padded inside the artifact;
dynamic: any batch; fixed: padded and chunked by the artifact's
``any_batch``) or any ``images ->
logits`` callable. With ``normalize=True`` the requests are uint8 crops
(:func:`.data.pipeline.preprocess_u8`): the worker copies the batch from
pinned memory to the device and normalizes it there
(:func:`.data.device.normalize_images`, bit for bit the host's), on the
thread's current stream, the stream the forward then runs on; the logits'
copy back to the host waits for both.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

__all__ = ["BatchingEngine", "ServingStats", "make_server", "main"]


class ServingStats:
    """Thread-safe rolling serving metrics: counters under a lock and a
    bounded window of request latencies for the percentiles."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._lat_ms = deque(maxlen=window)
        self._batch_sizes = deque(maxlen=window)
        self._requests = 0
        self._batches = 0
        self._t0 = time.perf_counter()

    def record_batch(self, size: int, latencies_ms: list) -> None:
        with self._lock:
            self._requests += size
            self._batches += 1
            self._batch_sizes.append(size)
            self._lat_ms.extend(latencies_ms)

    def snapshot(self) -> dict:
        """Request and batch counts, the mean batch, requests per second of
        wall time, and the p50/p99 request latency (ms)."""
        with self._lock:
            lat = np.asarray(self._lat_ms, np.float64)
            sizes = np.asarray(self._batch_sizes, np.float64)
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "requests": self._requests,
                "batches": self._batches,
                "mean_batch": float(sizes.mean()) if sizes.size else 0.0,
                "throughput_req_s": self._requests / elapsed,
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
            }


class _Request:
    __slots__ = ("image", "future", "t_submit")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class BatchingEngine:
    """Coalesce concurrent single-image requests into device batches.

    ``serve_fn`` is a :func:`.export.load_exported` callable (its
    ``buckets``, ``dynamic_batch``, ``input_spec`` and ``device`` set the
    padding and the device) or any callable taking any batch. ``max_batch``
    caps one forward (default: the largest bucket, the fixed batch, or 256).
    ``max_delay_ms`` is how long the worker holds the oldest request while
    more arrive. ``normalize``: the requests are uint8 ``[H, W, 3]`` crops,
    normalized on the device; else arrays of the model's input, cast there.
    ``device`` is where a plain callable's batches go (an artifact's own
    device otherwise; the card by default).
    """

    def __init__(
        self,
        serve_fn,
        max_batch: int | None = None,
        max_delay_ms: float = 5.0,
        normalize: bool = True,
        autostart: bool = True,
        device=None,
    ):
        self._serve = serve_fn
        self._normalize = normalize
        spec = getattr(serve_fn, "input_spec", None)
        buckets = getattr(serve_fn, "buckets", None)
        dynamic = getattr(serve_fn, "dynamic_batch", True)
        #: the per-image shape requests must have (None for a plain callable)
        self.image_shape = tuple(spec.shape[1:]) if spec is not None else None
        self._in_dtype = spec.dtype if spec is not None else None
        self.device = torch.device(device or getattr(serve_fn, "device", None) or "cuda")
        # a fixed batch sets the default cap and the warmup's batch
        self._fixed = (int(spec.shape[0]) if spec is not None and buckets is None
                       and not dynamic else None)
        if max_batch is None:
            max_batch = int(buckets[-1]) if buckets else self._fixed or 256
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.stats = ServingStats()
        self._q: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, name="rajni-batcher", daemon=True)
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    def stop(self) -> None:
        """Drain the queue, finish the batches in flight, join the worker."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def warmup(self) -> None:
        """One zeros batch through each program the engine can run: each
        bucket, the fixed batch, or ``max_batch``: the first launches'
        set-up is paid here, not by the first requests (an artifact's loader
        has built the kernels already; for a plain callable on a fresh
        machine the first warmup builds them). Stats are not touched."""
        shape = self.image_shape or (224, 224, 3)
        dtype = self._in_dtype if self._in_dtype is not None else torch.float32
        sizes = [int(b) for b in getattr(self._serve, "buckets", None) or []] or [
            self._fixed or self.max_batch]
        for b in sizes:
            self._call(torch.zeros((b,) + tuple(shape), dtype=dtype, device=self.device)).cpu()

    # -- request path ------------------------------------------------------
    def submit(self, image: np.ndarray) -> Future:
        """Queue one image; return a Future of its ``[num_classes]`` float32
        logits row. A shape or dtype that does not fit raises here."""
        image = np.asarray(image)
        if self.image_shape is not None and tuple(image.shape) != self.image_shape:
            raise ValueError(f"request shape {image.shape} != artifact input {self.image_shape}")
        if self._normalize and image.dtype != np.uint8:
            raise ValueError(f"normalize=True engines take uint8 crops, got {image.dtype}")
        req = _Request(image)
        self._q.put(req)
        return req.future

    def classify(self, image: np.ndarray) -> np.ndarray:
        """Blocking form of :meth:`submit`."""
        return self.submit(image).result()

    # -- worker ------------------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                first = self._q.get(timeout=0.02)
            except queue.Empty:
                continue
            batch = [first]
            deadline = first.t_submit + self.max_delay_s
            while len(batch) < self.max_batch:
                wait = deadline - time.perf_counter()
                if wait <= 0 and self._q.empty():
                    break
                try:
                    batch.append(self._q.get(timeout=max(wait, 0.0)))
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _run_batch(self, batch: list) -> None:
        try:
            x = torch.from_numpy(np.stack([r.image for r in batch]))
            if self.device.type == "cuda":
                # pinned, then on this thread's current stream: the forward's
                x = x.pin_memory().to(self.device, non_blocking=True)
            else:
                x = x.to(self.device)
            if self._normalize:
                from .data.device import normalize_images

                x = normalize_images(x, self._in_dtype or torch.float32)
            elif self._in_dtype is not None:
                x = x.to(self._in_dtype)
            # the copy to the host waits for the forward on that stream
            logits = self._call(x).float().cpu().numpy()
        except Exception as e:  # noqa: BLE001 — failures go to the futures
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        done = time.perf_counter()
        lat_ms = [(done - r.t_submit) * 1e3 for r in batch]
        for r, row in zip(batch, logits):
            if not r.future.cancelled():
                r.future.set_result(row)
        self.stats.record_batch(len(batch), lat_ms)

    def _call(self, x: torch.Tensor) -> torch.Tensor:
        """One forward at any batch: an artifact's ``any_batch`` pads and
        chunks a fixed batch (:func:`.export.run_padded`); a plain callable
        takes any batch itself."""
        return getattr(self._serve, "any_batch", self._serve)(x)


# -- HTTP front end ----------------------------------------------------------

def make_server(engine, host: str = "127.0.0.1", port: int = 8000, top_k: int = 5):
    """A ``ThreadingHTTPServer`` (not started) over one
    :class:`BatchingEngine` or a ``{name: engine}`` registry.

    * ``POST /v1/classify`` or ``/v1/models/<m>/classify``: the body is an
      encoded image (``Content-Type: image/*``; decoded and center-cropped
      as the eval pipeline does) or a uint8 ``[H, W, 3]`` crop
      (``application/octet-stream``, exactly the model's byte count).
      Response ``{"top_classes": [...], "top_logits": [...], "latency_ms":
      x}``; 400 on a body that does not fit.
    * ``GET /healthz``; ``GET /v1/models`` (the registry's names);
      ``GET /v1/stats`` or ``/v1/models/<m>/stats`` (a ``{name:
      snapshot}`` map from the bare form when there are several models).
    * 404 on any other path. Without ``/models/<m>``, the first model.

    The listen backlog is 128 connections (the stdlib's default is 5).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    engines = dict(engine) if isinstance(engine, dict) else {"default": engine}
    if not engines:
        raise ValueError("make_server needs at least one engine")
    default = next(iter(engines))
    multi = isinstance(engine, dict) and len(engines) > 1

    def resolve(path: str, leaf: str):
        if path == f"/v1/{leaf}":
            return engines[default]
        prefix, suffix = "/v1/models/", f"/{leaf}"
        if path.startswith(prefix) and path.endswith(suffix):
            return engines.get(path[len(prefix):-len(suffix)])
        return None

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/v1/models":
                self._json(200, {"models": list(engines)})
            elif self.path == "/v1/stats" and multi:
                self._json(200, {n: e.stats.snapshot() for n, e in engines.items()})
            elif (eng := resolve(self.path, "stats")) is not None:
                self._json(200, eng.stats.snapshot())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802 — http.server API
            eng = resolve(self.path, "classify")
            if eng is None:
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            ctype = self.headers.get("Content-Type", "")
            t0 = time.perf_counter()
            try:
                row = eng.submit(self._decode(eng, body, ctype)).result()
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._json(400, {"error": str(e)})
                return
            order = np.argsort(row)[::-1][:top_k]
            self._json(200, {
                "top_classes": [int(i) for i in order],
                "top_logits": [float(row[i]) for i in order],
                "latency_ms": (time.perf_counter() - t0) * 1e3,
            })

        def _decode(self, eng, body: bytes, ctype: str) -> np.ndarray:
            shape = eng.image_shape or (224, 224, 3)
            if ctype.startswith("application/octet-stream"):
                n = int(np.prod(shape))
                if len(body) != n:
                    raise ValueError(f"raw body must be {n} bytes for uint8 {shape}, "
                                     f"got {len(body)}")
                return np.frombuffer(body, np.uint8).reshape(shape)
            import io

            from PIL import Image

            from .data.pipeline import preprocess_u8

            with Image.open(io.BytesIO(body)) as im:
                return preprocess_u8(im.convert("RGB"), shape[0])

        def log_message(self, *args):  # no stderr line a request
            pass

    class Server(ThreadingHTTPServer):
        # the listen backlog: a burst of clients connecting at once past the
        # socketserver default of 5 would be reset before a thread took them
        request_queue_size = 128

    return Server((host, port), Handler)


def main(argv=None) -> None:
    """CLI: ``python -m rajni_tpu_torch.serving a.rajni b.rajni --names
    stock,pruned --port 8000``: several artifacts serve as a registry from
    one process (``POST /v1/models/pruned/classify``; the first is also the
    default model at ``/v1/classify``)."""
    import argparse
    import os

    from .export import load_exported

    p = argparse.ArgumentParser("rajni-tpu-torch dynamic-batching model server")
    p.add_argument("artifacts", nargs="+", metavar="artifact",
                   help=".rajni artifact(s) of rajni_tpu_torch.export; several serve as a "
                        "registry")
    p.add_argument("--names", default=None,
                   help="comma list naming each artifact in request paths (default: the "
                        "file stems)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_delay_ms", type=float, default=5.0,
                   help="batching window from the oldest queued request")
    p.add_argument("--max_batch", type=int, default=None,
                   help="cap one forward (default: the largest bucket / fixed batch)")
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the zeros batches at start-up (the first requests then "
                        "pay for the first launches)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    names = (args.names.split(",") if args.names
             else [os.path.splitext(os.path.basename(a))[0] for a in args.artifacts])
    if len(names) != len(args.artifacts) or len(set(names)) != len(names):
        raise ValueError(f"--names needs {len(args.artifacts)} distinct entries, got {names}")
    engines: dict[str, BatchingEngine] = {}
    for name, path in zip(names, args.artifacts):
        t0 = time.perf_counter()
        serve_fn = load_exported(path, args.device)  # builds the kernels on a fresh machine
        print(f"loaded {name!r} in {time.perf_counter() - t0:.1f} s")
        engines[name] = eng = BatchingEngine(serve_fn, max_batch=args.max_batch,
                                             max_delay_ms=args.max_delay_ms)
        if not args.no_warmup:
            t0 = time.perf_counter()
            eng.warmup()
            print(f"warmup[{name}]: {time.perf_counter() - t0:.1f} s")
        flavor = (f"buckets {serve_fn.buckets}" if serve_fn.buckets
                  else "dynamic batch" if serve_fn.dynamic_batch
                  else f"fixed batch {serve_fn.input_spec.shape[0]}")
        print(f"model {name!r}: {path} ({flavor}, max_batch={eng.max_batch}, "
              f"{serve_fn.route})")
    httpd = make_server(engines if len(engines) > 1 else engines[names[0]], args.host,
                        args.port, args.top_k)
    print(f"serving {len(engines)} model(s) on http://{args.host}:{httpd.server_address[1]} "
          f"[delay={args.max_delay_ms}ms]")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        for eng in engines.values():
            eng.stop()


if __name__ == "__main__":
    main()
