"""The port's dynamic-batching engine and HTTP front end
(``rajni_tpu_torch/serving.py``) against the JAX package's, on the CPU.

tests/test_serving.py's cases on the port's artifacts (tests/test_serving.py's
narrow ``CFG`` and schedule, JAX-initialized params, ``platform="cpu"``):
the engine against direct calls of its artifact, coalescing, chunking past
``max_batch``, buckets, warmup, request validation and recovery after a
failed batch; the port's engine and JAX's engine on the same uint8 requests
(top classes equal, logits at rtol 1e-4 / atol 1e-5); HTTP on 127.0.0.1,
port 0, one model and a registry. Then the kernel library's first load from
two threads at once, with the build stubbed (nothing calls nvcc here): one
build, one load.
"""

from __future__ import annotations

import ctypes
import http.client
import io
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import export as jexport
from rajni_tpu import serving as jserving
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch.data.device import normalize_images
from rajni_tpu_torch.export import export_model, load_exported
from rajni_tpu_torch.kernels import build
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.serving import BatchingEngine, make_server
from tests.test_serving import CFG, SCHED

ACT = dict(rtol=1e-4, atol=1e-5)
TCFG = tvit.ViTConfig(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
                      num_classes=6)
TIMEOUT = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0), CFG, jnp.float32))


def _artifact(tmp_path, jax_params, batch, name="m.rajni", schedule=SCHED):
    path = str(tmp_path / name)
    export_model(path, params_from_numpy(jax_params), TCFG, schedule, batch=batch,
                 dtype=torch.float32, platform="cpu")
    return load_exported(path, device="cpu")


def _crops(rng, n):
    return [rng.integers(0, 256, (16, 16, 3), np.uint8) for _ in range(n)]


def _normalized(crops):
    return normalize_images(torch.from_numpy(np.stack(crops)), torch.float32)


def test_engine_matches_direct(tmp_path, rng, jax_params):
    serve = _artifact(tmp_path, jax_params, batch=4)
    crops = _crops(rng, 3)
    with BatchingEngine(serve, max_delay_ms=20.0) as eng:
        assert eng.device == torch.device("cpu") and eng.max_batch == 4
        got = np.stack([f.result(timeout=TIMEOUT) for f in [eng.submit(c) for c in crops]])
    # the engine's path: normalized on the device, padded to the fixed batch
    padded = torch.cat([_normalized(crops), torch.zeros(1, 16, 16, 3)])
    np.testing.assert_array_equal(got, serve(padded)[:3].numpy())


def test_engine_coalesces_queued_requests(tmp_path, rng, jax_params):
    serve = _artifact(tmp_path, jax_params, batch=4)
    eng = BatchingEngine(serve, max_delay_ms=5.0, autostart=False)
    futs = [eng.submit(c) for c in _crops(rng, 3)]
    eng.start()  # all three queued before the worker woke: one batch
    for f in futs:
        f.result(timeout=TIMEOUT)
    eng.stop()
    assert not eng._thread.is_alive()
    snap = eng.stats.snapshot()
    assert (snap["requests"], snap["batches"], snap["mean_batch"]) == (3, 1, 3.0)
    assert snap["p99_ms"] >= snap["p50_ms"] > 0.0


def test_engine_chunks_past_max_batch(tmp_path, rng, jax_params):
    serve = _artifact(tmp_path, jax_params, batch=2)
    eng = BatchingEngine(serve, max_delay_ms=5.0, autostart=False)
    assert eng.max_batch == 2
    futs = [eng.submit(c) for c in _crops(rng, 5)]
    eng.start()
    rows = [f.result(timeout=TIMEOUT) for f in futs]
    eng.stop()
    assert all(r.shape == (6,) and r.dtype == np.float32 for r in rows)
    snap = eng.stats.snapshot()
    assert (snap["requests"], snap["batches"]) == (5, 3)  # 2 + 2 + 1


def test_engine_buckets_and_warmup(tmp_path, rng, jax_params):
    serve = _artifact(tmp_path, jax_params, batch=[2, 4], name="b.rajni")
    calls = []

    def spy(x):
        calls.append(int(x.shape[0]))
        return serve(x)

    spy.buckets, spy.dynamic_batch, spy.input_spec = (serve.buckets, serve.dynamic_batch,
                                                      serve.input_spec)
    spy.device = serve.device
    crops = _crops(rng, 3)
    eng = BatchingEngine(spy, max_delay_ms=20.0, autostart=False)
    assert eng.max_batch == 4  # the largest bucket
    eng.warmup()
    assert calls == [2, 4] and eng.stats.snapshot()["requests"] == 0
    futs = [eng.submit(c) for c in crops]
    eng.start()  # the three queued: one batch
    got = np.stack([f.result(timeout=TIMEOUT) for f in futs])
    eng.stop()
    assert calls == [2, 4, 3]  # the bucket artifact pads the 3 to 4 itself
    np.testing.assert_array_equal(got, serve(_normalized(crops)).numpy())


def test_engine_validates_requests(tmp_path, rng, jax_params):
    serve = _artifact(tmp_path, jax_params, batch=2)
    with BatchingEngine(serve) as eng:
        with pytest.raises(ValueError, match="shape"):
            eng.submit(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            eng.submit(np.zeros((16, 16, 3), np.float32))


def test_engine_failed_batch_recovers():
    calls = []

    def flaky(x):  # a plain callable: no input_spec, any batch
        calls.append(int(x.shape[0]))
        if x.shape[0] == 2:
            raise RuntimeError("boom")
        return torch.zeros(x.shape[0], 6)

    eng = BatchingEngine(flaky, max_delay_ms=5.0, normalize=False, autostart=False,
                         device="cpu")
    img = np.zeros((16, 16, 3), np.float32)
    bad = [eng.submit(img), eng.submit(img)]  # coalesced into the batch of 2
    eng.start()
    for f in bad:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=TIMEOUT)
    assert eng.submit(img).result(timeout=TIMEOUT).shape == (6,)  # the worker lives on
    eng.stop()
    assert calls[0] == 2


def test_engine_matches_jax_engine(tmp_path, rng, jax_params):
    """The same uint8 requests through the port's engine over its bucket
    artifact and JAX's engine over JAX's, from the same params."""
    serve = _artifact(tmp_path, jax_params, batch=[2, 4])
    jpath = str(tmp_path / "jax.rajni")
    jexport.export_model(jpath, jax_params, CFG, SCHED, batch=[2, 4], dtype=jnp.float32,
                         platform="cpu", impl="xla")
    crops = _crops(rng, 7)
    results = {}
    for name, eng in (("port", BatchingEngine(serve, max_delay_ms=10.0, autostart=False)),
                      ("jax", jserving.BatchingEngine(jexport.load_exported(jpath),
                                                      max_delay_ms=10.0, autostart=False))):
        futs = [eng.submit(c) for c in crops]
        eng.start()
        results[name] = np.stack([f.result(timeout=TIMEOUT) for f in futs])
        eng.stop()
        assert eng.stats.snapshot()["batches"] == 2  # 4 + 3
    np.testing.assert_array_equal(results["port"].argmax(1), results["jax"].argmax(1))
    np.testing.assert_allclose(results["port"], results["jax"], **ACT)


def _get(conn, path):
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _post(conn, path, body, ctype):
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_http_server_roundtrip(tmp_path, rng, jax_params):
    from PIL import Image

    eng = BatchingEngine(_artifact(tmp_path, jax_params, batch=2), max_delay_ms=2.0)
    httpd = make_server(eng, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=TIMEOUT)
        assert _get(conn, "/healthz") == (200, {"ok": True})
        assert _get(conn, "/v1/models") == (200, {"models": ["default"]})
        crop = rng.integers(0, 256, (16, 16, 3), np.uint8)
        status, out = _post(conn, "/v1/classify", crop.tobytes(), "application/octet-stream")
        assert status == 200 and len(out["top_classes"]) == 5 and out["latency_ms"] > 0
        row = eng.classify(crop)
        assert out["top_classes"] == np.argsort(row)[::-1][:5].tolist()
        np.testing.assert_allclose(out["top_logits"], np.sort(row)[::-1][:5], rtol=1e-6)
        buf = io.BytesIO()  # an encoded image: decoded and center-cropped here
        Image.fromarray(rng.integers(0, 256, (24, 20, 3), np.uint8)).save(buf, format="PNG")
        status, out = _post(conn, "/v1/classify", buf.getvalue(), "image/png")
        assert status == 200 and len(out["top_classes"]) == 5
        status, out = _post(conn, "/v1/classify", b"abc", "application/octet-stream")
        assert status == 400 and "768 bytes" in out["error"]
        assert _get(conn, "/v1/nothing")[0] == 404
        status, snap = _get(conn, "/v1/stats")
        assert status == 200 and snap["requests"] >= 3 and snap["p50_ms"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.stop()
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()


def test_http_multi_model_registry(tmp_path, rng, jax_params):
    engines = {"pruned": BatchingEngine(_artifact(tmp_path, jax_params, 2, "p.rajni"),
                                        max_delay_ms=2.0),
               "stock": BatchingEngine(_artifact(tmp_path, jax_params, 2, "s.rajni", None),
                                       max_delay_ms=2.0)}
    httpd = make_server(engines, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=TIMEOUT)
        assert _get(conn, "/v1/models") == (200, {"models": ["pruned", "stock"]})
        crop = rng.integers(0, 256, (16, 16, 3), np.uint8)
        outs = {p: _post(conn, p, crop.tobytes(), "application/octet-stream")[1]["top_logits"]
                for p in ("/v1/classify", "/v1/models/pruned/classify",
                          "/v1/models/stock/classify")}
        assert outs["/v1/classify"] == outs["/v1/models/pruned/classify"]
        assert outs["/v1/models/stock/classify"] != outs["/v1/classify"]
        assert _post(conn, "/v1/models/nope/classify", b"", "image/png")[0] == 404
        assert _get(conn, "/v1/models/stock/stats")[1]["requests"] == 1
        agg = _get(conn, "/v1/stats")[1]
        assert agg["pruned"]["requests"] == 2 and agg["stock"]["requests"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        for e in engines.values():
            e.stop()


def test_first_library_load_from_two_threads_builds_once(monkeypatch):
    """Two threads whose first launches meet in ``kernels/build.py:_library``
    get one build and one load (the objects and the temporary library are
    named by pid: two builds in one process would write the same files)."""
    builds, loads, inside = [], [], []

    def slow_build():
        inside.append(1)
        assert len(inside) == 1, "two builds at once"
        time.sleep(0.05)
        builds.append(threading.current_thread().name)
        inside.pop()
        return {}

    class Lib:
        def __init__(self, path):
            loads.append(path)
            self.rajni_error_string = lambda code: b""

    monkeypatch.setattr(build, "_build", slow_build)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    barrier = threading.Barrier(2)
    got = []

    def first_launch():
        barrier.wait(timeout=TIMEOUT)
        got.append(build._library())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_launch, name=f"engine{i}") for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 2 and got[0] is got[1]
    # and build() itself serializes: two threads never build at once
    threads = [threading.Thread(target=build.build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert len(builds) == 4 and not inside
