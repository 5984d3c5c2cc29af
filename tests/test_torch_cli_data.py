"""The port's eval CLI on an image folder (``rajni_tpu_torch/run.py`` with
``--data_path``) against the JAX package's, on the CPU.

A temporary ImageFolder of 24 procedural images in 3 classes (four sizes,
upscaled and downscaled), ``vit_tiny_patch16_64``, ``--device cpu --dtype
float32``, one pruned block. Both CLIs read the same checkpoint, a msgpack
written by the JAX package or a timm-layout ``.pth`` that each converts on
loading, and evaluate it in each ``--preprocess`` tier: the same accuracy and
the same prediction for every image. Both host tiers run PIL here (the JAX
loader's C++ library is switched off, so this file never builds it; the
port's by ``RAJNI_NATIVE=0``); the port's C++ tier runs on its own and
names itself. Then ``--calibrate 1 --quantize`` through the device stages,
``--profile``, and the flag rules.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from rajni_tpu import run as jrun
from rajni_tpu.data import native as jnative
from rajni_tpu.models import vit as jvit
from rajni_tpu.params import io as jio
from rajni_tpu_torch import run as trun

MODEL = "vit_tiny_patch16_64"
SIZES = [(90, 70), (70, 90), (40, 50), (120, 160)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    for c in ("cat", "dog", "eel"):
        d = root / "data" / c
        d.mkdir(parents=True)
        for i in range(8):
            h, w = SIZES[i % 4]
            y = np.linspace(0, 1, h)[:, None, None]
            x = np.linspace(0, 1, w)[None, :, None]
            arr = 255 * (0.5 * y + 0.5 * x) * rng.uniform(0.2, 1.0, 3) + rng.normal(0, 40, (h, w, 3))
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(d / f"{i}.png")
    sched = root / "s.json"
    sched.write_text(json.dumps({"2": {"keep_ratio": 0.7}}))
    cfg = jvit.get_config(MODEL)
    msgpack = root / "p.msgpack"
    jio.save_params(str(msgpack), jvit.init_params(jax.random.key(3), cfg))
    gen = torch.Generator().manual_seed(4)
    C, hidden = cfg.embed_dim, cfg.mlp_hidden

    def rand(*shape, std=0.05):
        return std * torch.randn(*shape, generator=gen)

    sd = {"cls_token": rand(1, 1, C), "pos_embed": rand(1, cfg.num_tokens, C),
          "patch_embed.proj.weight": rand(C, 3, 16, 16), "patch_embed.proj.bias": rand(C),
          "norm.weight": 1 + rand(C), "norm.bias": rand(C),
          "head.weight": rand(1000, C), "head.bias": rand(1000)}
    for i in range(cfg.depth):
        for leaf, shape in (("norm1", (C,)), ("norm2", (C,)), ("attn.qkv", (3 * C, C)),
                            ("attn.proj", (C, C)), ("mlp.fc1", (hidden, C)),
                            ("mlp.fc2", (C, hidden))):
            sd[f"blocks.{i}.{leaf}.weight"] = (1 + rand(*shape) if len(shape) == 1
                                               else rand(*shape, std=C ** -0.5))
            sd[f"blocks.{i}.{leaf}.bias"] = rand(shape[0])
    pth = root / "p.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, pth)
    return {"data": str(root / "data"), "schedule": str(sched), "msgpack": str(msgpack),
            "pth": str(pth)}


def _argv(files, tier, ckpt, batch=10):
    return ["--data_path", files["data"], "--schedule", files["schedule"], "--model", MODEL,
            "--dtype", "float32", "--batch_size", str(batch), "--warmup", "0",
            "--num_workers", "2", "--preprocess", tier, "--canvas", "128",
            "--checkpoint", files[ckpt]]


def _recording(module, monkeypatch) -> list:
    """Record each batch's predictions of ``module.run``'s evaluations."""
    preds, real = [], module.evaluate_model

    def evaluate(model, *args, **kw):
        def recorded(x):
            out = model(x)
            preds.append(np.asarray(out.detach() if hasattr(out, "detach") else out).argmax(1))
            return out

        return real(recorded, *args, **kw)

    monkeypatch.setattr(module, "evaluate_model", evaluate)
    return preds


@pytest.mark.parametrize("tier,ckpt", [("host", "msgpack"), ("device", "msgpack"),
                                       ("device-full", "msgpack"), ("host", "pth"),
                                       ("device-full", "pth")])
def test_port_and_jax_clis_predict_alike(files, monkeypatch, capsys, tier, ckpt):
    monkeypatch.setattr(jnative, "load", lambda: None)  # the JAX loader on PIL
    monkeypatch.setenv("RAJNI_NATIVE", "0")
    jpreds = _recording(jrun, monkeypatch)
    want = jrun.main(_argv(files, tier, ckpt))["rajni"][0]
    tpreds = _recording(trun, monkeypatch)
    got = trun.main(_argv(files, tier, ckpt) + ["--device", "cpu"])["rajni"][0]
    out = capsys.readouterr().out
    assert f"preprocess: {'host (PIL)' if tier == 'host' else tier}" in out.splitlines()
    assert "route: torch" in out.splitlines()
    assert got == want
    assert [len(p) for p in tpreds] == [10, 10, 4]  # JAX pads its last batch to 10 rows
    np.testing.assert_array_equal(np.concatenate(tpreds),
                                  np.concatenate([j[:len(t)] for t, j in zip(tpreds, jpreds)]))


def test_native_host_tier_names_itself(files, monkeypatch, capsys):
    monkeypatch.delenv("RAJNI_NATIVE", raising=False)
    preds = _recording(trun, monkeypatch)
    acc, _ = trun.main(_argv(files, "host", "msgpack") + ["--device", "cpu"])["rajni"]
    assert "preprocess: host (native)" in capsys.readouterr().out.splitlines()
    native = np.concatenate(preds)
    monkeypatch.setenv("RAJNI_NATIVE", "0")
    preds.clear()
    assert trun.main(_argv(files, "host", "msgpack") + ["--device", "cpu"])["rajni"][0] == acc
    assert "preprocess: host (PIL)" in capsys.readouterr().out.splitlines()
    # ±1/255 input differences leave these predictions where they were
    np.testing.assert_array_equal(native, np.concatenate(preds))


@pytest.mark.parametrize("tier", ["device", "device-full"])
def test_calibration_batches_go_through_the_device_stage(files, monkeypatch, capsys, tier):
    seen, real = [], trun.calibrate_act_scales

    def spy(params, batches, *args, **kw):
        seen.append([(tuple(b.shape), b.dtype) for b in batches])
        return real(params, batches, *args, **kw)

    monkeypatch.setattr(trun, "calibrate_act_scales", spy)
    trun.main(_argv(files, tier, "msgpack") + ["--device", "cpu", "--quantize",
                                                "--calibrate", "1"])
    assert seen == [[((10, 64, 64, 3), torch.float32)]]
    assert "Calibrated static int8 activation scales (pruned forward)" in capsys.readouterr().out


def test_profile_writes_a_chrome_trace(files, tmp_path, capsys):
    trun.main(_argv(files, "device", "msgpack", batch=12)
              + ["--device", "cpu", "--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert f"Wrote the trace {tmp_path / 'prof' / 'trace.json'}" in capsys.readouterr().out


def test_flag_rules(files, capsys):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main(_argv(files, "host", "msgpack") + ["--device", "cuda"])
    with pytest.raises(ValueError, match="provide --data_path or --synthetic N"):
        trun.main(["--schedule", files["schedule"], "--device", "cpu"])
    trun.main(["--synthetic", "1", "--batch_size", "2", "--model", MODEL, "--schedule",
               files["schedule"], "--device", "cpu", "--dtype", "float32", "--warmup", "0",
               "--preprocess", "device-full"])
    out = capsys.readouterr().out
    assert "forcing --preprocess host" in out
    assert "preprocess: none (synthetic batches)" in out.splitlines()
