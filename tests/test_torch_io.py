"""The port's msgpack checkpoints, the replay of the committed reference
fixture, the route the card takes (the demotion of configs and dtypes the
CUDA kernels do not take), and the training and eval CLIs on the CPU.

A checkpoint written by either package must load in the other leaf for leaf:
same tree, same dtypes, same bits (bf16 leaves and int8 records included).
The fixture replay holds the port to the original reference's logits as
tests/test_attest.py:123-124 holds JAX: top-1 agreement 1.0, max abs diff
< 1e-4.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import quant as jquant
from rajni_tpu.models import vit as jvit
from rajni_tpu.params import io as jio
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params import io as tio
from rajni_tpu_torch.params.from_jax import params_to_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "reference_vit_tiny_schedulejson"
CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=10,
           use_layer_scale=True)


def _bits(a) -> tuple[str, np.ndarray]:
    """A leaf's dtype name and its bits (bf16 through an int16 view)."""
    if isinstance(a, torch.Tensor):  # bf16: numpy has no such dtype
        return "bfloat16", a.view(torch.int16).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16)
    return a.dtype.name, a


def _assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        (dx, bx), (dy, by) = _bits(x), _bits(y)
        assert dx == dy and bx.shape == by.shape
        np.testing.assert_array_equal(bx, by)


def _jax_tree(kind: str):
    """A JAX parameter tree: fp32, or bf16 with int8 records."""
    p = jvit.init_params(jax.random.key(0), jvit.ViTConfig(**CFG), jnp.float32)
    if kind == "bf16+int8":
        p = jquant.quantize_params(jax.tree.map(lambda a: a.astype(jnp.bfloat16), p))
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("kind", ["fp32", "bf16+int8"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_round_trip_both_ways(tmp_path, writer, kind):
    tree = _jax_tree(kind)
    path = str(tmp_path / "p.msgpack")
    if writer == "port":
        from rajni_tpu_torch import params_from_numpy

        tio.save_params(path, params_from_numpy(tree))
        _assert_same_tree(jax.tree.map(np.asarray, jio.load_params(path)), tree)
    else:
        jio.save_params(path, tree)
        _assert_same_tree(params_to_numpy(tio.load_params(path)), tree)


def test_chunked_arrays_raise(tmp_path):
    path = tmp_path / "c.msgpack"
    path.write_bytes(tio._packb({"a": {"__msgpack_chunked_array__": True, "shape": {}}}))
    with pytest.raises(ValueError, match="chunked"):
        tio.load_params(str(path))


def test_fixture_replay_matches_the_reference():
    """The reference fixture (vit_tiny, REFERENCE_SCHEDULE, 16 images, logits
    of the original PyTorch program in fp32) through the port's own decoder
    and ``impl="torch"`` in fp32."""
    fix = np.load(f"{FIXTURE}.npz")
    params = tio.load_params(f"{FIXTURE}.msgpack", dtype=torch.float32)
    config = tvit.get_config(str(fix["model"]))
    schedule = {int(k): v for k, v in json.loads(str(fix["schedule"])).items()}
    logits = tvit.vit_forward(params, torch.from_numpy(fix["images"]), config, schedule,
                              "torch").numpy()
    ref = fix["logits"]
    assert float(np.mean(logits.argmax(-1) == ref.argmax(-1))) == 1.0
    assert float(np.abs(logits - ref).max()) < 1e-4


@pytest.mark.parametrize("model,dtype,route", [
    ("vit_tiny_patch16_224", torch.bfloat16, "route: torch (C=192 is not a multiple of 128)"),
    ("vit_base_patch16_224", torch.bfloat16, "route: cuda"),
    ("vit_base_patch16_384", torch.bfloat16, "route: cuda"),
    ("vit_huge_patch14_224", torch.bfloat16, "route: cuda"),
    ("vit_base_patch16_224", torch.float32,
     "route: torch (float32 activations (the kernels take bfloat16))"),
])
def test_card_route_demotes_what_the_kernels_do_not_take(model, dtype, route):
    """On a CUDA device ``auto`` and ``cuda`` demote before any launch; on
    the CPU the kernels' plain versions take every config, as JAX's
    interpret mode does (``pallas_compilable``)."""
    config = tvit.get_config(model)
    for impl in ("auto", "cuda"):
        assert tvit.route_line(*tvit.resolve_route(impl, config, dtype, "cuda")) == route
    assert tvit.resolve_route("cuda", config, dtype, "cpu") == ("cuda", "")
    assert tvit.resolve_route("auto", config, dtype, "cpu") == ("torch", "")
    assert tvit.resolve_route("torch", config, dtype, "cuda") == ("torch", "")


def test_train_cli_writes_a_checkpoint_both_packages_load(tmp_path, capsys):
    """The training CLI on the kernel route (plain versions on the CPU) for a
    few steps, then the eval CLI on its output."""
    from rajni_tpu_torch import run as trun
    from rajni_tpu_torch import train as ttrain

    out = tmp_path / "t.msgpack"
    sched = tmp_path / "s.json"
    sched.write_text(json.dumps({"2": {"keep_ratio": 0.7, "update": True}}))
    state = ttrain.main([
        "--synthetic", "--model", "vit_tiny_patch16_64", "--schedule", str(sched), "--steps", "3",
        "--batch_size", "2", "--kernels", "cuda", "--device", "cpu", "--grad_accum", "1",
        "--lr_schedule", "cosine", "--warmup_steps", "1", "--grad_clip", "1.0",
        "--label_smoothing", "0.1", "--output", str(out), "--log_every", "1",
    ])
    printed = capsys.readouterr().out
    assert "route: cuda" in printed and printed.count("step ") == 3
    assert state.step == 3
    _assert_same_tree(jax.tree.map(np.asarray, jio.load_params(str(out))),
                      params_to_numpy(tio.load_params(str(out))))
    _assert_same_tree(params_to_numpy(tio.load_params(str(out))),
                      params_to_numpy(state.params))
    trun.main(["--synthetic", "1", "--batch_size", "2", "--model", "vit_tiny_patch16_64",
               "--schedule", str(sched), "--checkpoint", str(out), "--device", "cpu",
               "--dtype", "float32", "--warmup", "0"])
    assert "route: torch" in capsys.readouterr().out
