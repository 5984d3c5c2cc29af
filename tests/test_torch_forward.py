"""The PyTorch port's forward, entry points and imports.

The same JAX-initialized params (carried over by ``params_from_numpy``) and
the same numpy images go through both packages, in fp32 on the CPU:
``impl="torch"`` against JAX ``impl="xla"``, and ``impl="cuda"`` (which on CPU
tensors runs the kernels' plain versions) against JAX ``impl="pallas"``
(interpret mode). Tolerances follow tests/test_kernels.py: rtol 1e-4 /
atol 1e-5 on logits; selections and token counts exactly.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.models import vit as jvit
from rajni_tpu.utils import flops as jflops
from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT, params_from_numpy
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.utils import flops as tflops


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parent.parent
ACT = dict(rtol=1e-4, atol=1e-5)
# tests/test_kernels.py:56's config and :60's schedule (block 2 reuses the
# scores threaded from block 1: the with_scores=False route)
CFG = dict(img_size=32, patch_size=8, embed_dim=48, depth=3, num_heads=4, num_classes=10)
SCHED = {1: {"keep_ratio": 0.6, "update": True}, 2: {"keep_ratio": 0.5, "update": False}}


def _setup(rng, layer_scale: bool):
    jcfg = jvit.ViTConfig(**CFG, use_layer_scale=layer_scale)
    tcfg = tvit.ViTConfig(**CFG, use_layer_scale=layer_scale)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0), jcfg))
    # non-trivial biases, norms and layer scales, so that each one is carried
    for blk in jp["blocks"]:
        for leaf in ("norm1", "norm2"):
            blk[leaf]["scale"] = 1 + 0.1 * rng.standard_normal(blk[leaf]["scale"].shape).astype(np.float32)
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * rng.standard_normal(d["bias"].shape).astype(np.float32)
        if layer_scale:
            blk["ls1"] = 0.5 * rng.standard_normal(blk["ls1"].shape).astype(np.float32)
            blk["ls2"] = 0.5 * rng.standard_normal(blk["ls2"].shape).astype(np.float32)
    jp["cls_token"] = 0.1 * rng.standard_normal(jp["cls_token"].shape).astype(np.float32)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp), images


@pytest.mark.parametrize("layer_scale", [False, True])
@pytest.mark.parametrize("schedule", [None, SCHED], ids=["identity", "pruned"])
def test_forward_matches_jax(rng, schedule, layer_scale):
    jcfg, tcfg, jp, tp, images = _setup(rng, layer_scale)
    jparams = jax.tree.map(jnp.asarray, jp)
    jsched = jvit.normalize_schedule(schedule, jcfg.depth)
    jsel, tsel_torch, tsel_cuda = {}, {}, {}
    want_xla = jvit.vit_forward(
        jparams, jnp.asarray(images), jcfg, jsched, "xla",
        _sel_tap=lambda i, k: jsel.__setitem__(i, np.asarray(k)),
    )
    want_pallas = jax.jit(jvit.vit_forward, static_argnums=(2, 3, 4))(
        jparams, jnp.asarray(images), jcfg, jsched, "pallas"
    )
    x = torch.from_numpy(images)
    got_torch = tvit.vit_forward(tp, x, tcfg, schedule, "torch",
                                 _sel_tap=lambda i, k: tsel_torch.__setitem__(i, k.numpy()))
    got_cuda = tvit.vit_forward(tp, x, tcfg, schedule, "cuda",
                                _sel_tap=lambda i, k: tsel_cuda.__setitem__(i, k.numpy()))
    np.testing.assert_allclose(got_torch.numpy(), np.asarray(want_xla), **ACT)
    np.testing.assert_allclose(got_cuda.numpy(), np.asarray(want_pallas), **ACT)
    # the fused JAX kernels keep their selections inside; the ops path's
    # selections are the ones both port routes must reproduce exactly
    assert sorted(jsel) == sorted(tsel_torch) == sorted(tsel_cuda)
    for i in jsel:
        np.testing.assert_array_equal(tsel_torch[i], jsel[i])
        np.testing.assert_array_equal(tsel_cuda[i], jsel[i])
    assert tvit.model_stats(tcfg, schedule) == jvit.model_stats(jcfg, jsched)


def test_config_grammar_and_stats_match_jax():
    for name in ("vit_tiny_patch16_64", "vit_base_patch16_224", "vit_base_patch16_384",
                 "deit_small_patch16_224", "deit3_base_patch16_224", "vit_large_patch14_336"):
        assert dataclasses.asdict(tvit.get_config(name)) == dataclasses.asdict(jvit.get_config(name))
    cfg = tvit.get_config("vit_base_patch16_224")
    counts = tvit.model_stats(cfg, REFERENCE_SCHEDULE)["token_counts"]
    assert counts == [197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120]
    jcfg = jvit.get_config("vit_base_patch16_224")
    assert tflops.flops_per_image(cfg, counts) == jflops.flops_per_image(jcfg, counts)
    with pytest.raises(ValueError):
        tvit.get_config("resnet50")
    # the extended variants initialize with JAX's leaves (tests/test_torch_variants.py)
    reg = tvit.init_params(torch.Generator(), tvit.get_config("vit_small_patch14_reg4_dinov2"))
    assert reg["reg_token"].shape == (1, 4, 384) and reg["pos_embed"].shape == (1, 37 * 37, 384)


def test_mfu_uses_the_h100_peak():
    cfg = tvit.get_config("vit_base_patch16_224")
    f = tflops.flops_per_image(cfg)
    assert tflops.mfu(cfg, None, 1000.0, "NVIDIA H100 80GB HBM3") == pytest.approx(f * 1000 / 989e12)
    assert tflops.mfu(cfg, None, 1000.0, "NVIDIA H100 PCIe") == pytest.approx(f * 1000 / 756e12)
    with pytest.raises(ValueError):
        tflops.mfu(cfg, None, 1000.0, "TPU v5 lite")


def test_rajnivit_on_cpu():
    model = RAJNIViT(tvit.ViTConfig(**CFG), SCHED, dtype=torch.float32, device="cpu")
    logits = model(torch.zeros(2, 32, 32, 3))
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    assert model.get_last_stats() == {"token_counts": [17, 17, 10]}


def test_evaluate_model_accounting():
    from rajni_tpu_torch.data.pipeline import SyntheticLoader
    from rajni_tpu_torch.eval import evaluate_model

    loader = SyntheticLoader(num_batches=3, batch_size=4, img_size=8, num_classes=5, seed=1)
    labels = torch.from_numpy(loader._labels)
    calls = []

    def model(x):  # right on the first two images of every batch
        calls.append(x.shape[0])
        logits = torch.nn.functional.one_hot(labels, 5).float()
        logits[2:] = torch.roll(logits[2:], 1, dims=1)
        return logits

    acc, ips = evaluate_model(model, loader, device="cpu", warmup=4)
    assert acc == pytest.approx(50.0)
    assert ips > 0 and len(calls) == 4 + 3
    acc, _ = evaluate_model(model, loader, device="cpu", warmup=0, max_batches=1)
    assert acc == pytest.approx(50.0)


def test_eval_cli_on_cpu(tmp_path):
    sched = tmp_path / "schedule.json"
    sched.write_text(json.dumps({str(k): v for k, v in REFERENCE_SCHEDULE.items()}))
    cmd = [sys.executable, "-m", "rajni_tpu_torch.run", "--device", "cpu", "--synthetic", "2",
           "--batch_size", "2", "--model", "vit_tiny_patch16_64", "--schedule", str(sched),
           "--kernels", "cuda", "--warmup", "1"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "RAJNI - Accuracy:" in p.stdout and "img/s" in p.stdout
    want = jvit.model_stats(jvit.get_config("vit_tiny_patch16_64"), REFERENCE_SCHEDULE)
    assert f"Token counts per block: {want['token_counts']}" in p.stdout


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-CUDA refusal cannot be shown")
    from rajni_tpu_torch import run
    from rajni_tpu_torch.eval import evaluate_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RAJNIViT(tvit.ViTConfig(**CFG), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_model(lambda x: x, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--synthetic", "1", "--model", "vit_tiny_patch16_64"])


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "rajni_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_port.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "rajni_tpu")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{f}: imports {name}"
