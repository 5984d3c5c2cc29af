"""The port's serving artifacts (``rajni_tpu_torch/export.py``) against the
JAX package's (``rajni_tpu/export.py``), on the CPU.

The same JAX-initialized params (tests/test_export.py's narrow ``CFG`` and
schedule) go into JAX's artifact (``export_model(..., platform="cpu",
impl="xla")`` then ``load_exported``) and the port's (``platform="cpu"``), at
buckets ``[2, 4]`` (requests of 1, 3 and 5: padded, exact and chunked), a
fixed batch of 2 and ``"dynamic"``: logits at rtol 1e-4 / atol 1e-5 in
fp32. Then JAX's int8 static-scale setup (tests/test_export.py:
``test_export_with_static_act_scales``), ``impl="auto"`` resolved against the
target platform (a ``cuda`` artifact written here routes the kernels and
refuses to load on the CPU), JAX's two artifact forms refused by name, the
validation, and the CLI on a timm ``.pth`` and on a msgpack.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import export as jexport
from rajni_tpu.models import vit as jvit
from rajni_tpu.params import io as jio
from rajni_tpu.quant import calibrate_act_scales as jcalibrate, quantize_params as jquantize
from rajni_tpu_torch import export as texport
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params import io as tio
from rajni_tpu_torch.quant import ActScales, calibrate_act_scales, quantize_params
from tests.test_export import CFG, SCHED
from tests.test_params import CFG as ORACLE_CFG, TorchOracleViT

ACT = dict(rtol=1e-4, atol=1e-5)
TCFG = tvit.ViTConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(tvit.ViTConfig)})
REQUESTS = (1, 3, 5)
FORMS = {"buckets": [2, 4], "fixed": 2, "dynamic": "dynamic"}


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
    return jax.tree.map(np.asarray, jvit.init_params(jax.random.key(7), CFG, jnp.float32))


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory, jax_params):
    """JAX's artifact of each form, written once."""
    root = tmp_path_factory.mktemp("jax_artifacts")
    paths = {}
    for form, batch in FORMS.items():
        paths[form] = str(root / f"{form}.rajni")
        jexport.export_model(paths[form], jax_params, CFG, SCHED, batch=batch,
                             dtype=jnp.float32, platform="cpu", impl="xla")
    return paths


def _images(rng, b):
    return rng.standard_normal((b, CFG.img_size, CFG.img_size, 3)).astype(np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_artifact_matches_jax(tmp_path, rng, jax_params, jax_artifacts, form):
    path = str(tmp_path / "port.rajni")
    header = texport.export_model(path, params_from_numpy(jax_params), TCFG, SCHED,
                                  batch=FORMS[form], dtype=torch.float32, platform="cpu")
    assert header["platform"] == "cpu" and header["dtype"] == "float32"
    assert {r["impl"] for r in header["routes"].values()} == {"torch"}
    serve = texport.load_exported(path, device="cpu")
    want_fn = jexport.load_exported(jax_artifacts[form])
    assert serve.buckets == want_fn.buckets
    assert serve.dynamic_batch == want_fn.dynamic_batch == (form == "dynamic")
    assert serve.input_spec.shape[1:] == tuple(want_fn.input_spec.shape[1:])
    if form != "dynamic":
        assert serve.input_spec.shape[0] == want_fn.input_spec.shape[0]
    assert serve.route == "route: torch"
    for b in (REQUESTS if form != "fixed" else (2,)):
        x = _images(rng, b)
        got = serve(x)
        assert got.shape == (b, CFG.num_classes) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want_fn(jnp.asarray(x))), **ACT,
                                   err_msg=f"{form} batch {b}")
    if form == "fixed":  # exactly its batch, as a jax.export program
        with pytest.raises(ValueError, match="exactly 2"):
            serve(_images(rng, 3))
    # any_batch (the server's and --artifact's entry): a fixed artifact pads
    # each chunk of its batch with zero images; the other forms are serve
    x = _images(rng, 3)
    padded = np.concatenate([x, np.zeros_like(x[:1])])
    want = (np.concatenate([np.asarray(want_fn(jnp.asarray(padded[i:i + 2])))
                            for i in (0, 2)])[:3] if form == "fixed" else
            np.asarray(want_fn(jnp.asarray(x))))
    np.testing.assert_allclose(serve.any_batch(x).numpy(), want, **ACT, err_msg=form)


def test_int8_static_artifact_matches_jax(tmp_path, rng, jax_params):
    """JAX's static-scale setup: scales calibrated on the batch (the port's
    equal JAX's), weights quantized, the scales baked. On a ``torch``-route
    artifact they do not apply (a warning, as JAX's xla route), and the
    logits match JAX's artifact; on a ``cuda`` artifact the header carries
    them in JAX's JSON form."""
    x = _images(rng, 2)
    jscales = jcalibrate(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(x), CFG, SCHED)
    tp = params_from_numpy(jax_params)
    scales = calibrate_act_scales(tp, torch.from_numpy(x), TCFG, SCHED)
    np.testing.assert_allclose(np.array(scales.blocks), np.array(jscales.blocks), rtol=1e-5)
    np.testing.assert_allclose(scales.head, jscales.head, rtol=1e-5)
    jpath, path = str(tmp_path / "jax.rajni"), str(tmp_path / "port.rajni")
    jexport.export_model(jpath, jquantize(jax.tree.map(jnp.asarray, jax_params)), CFG, SCHED,
                         batch=2, dtype=jnp.float32, platform="cpu", impl="xla",
                         act_scales=jscales)
    q = quantize_params(tp)
    texport.export_model(path, q, TCFG, SCHED, batch=2, dtype=torch.float32, platform="cpu",
                         impl="torch", act_scales=scales)
    got = texport.load_exported(path, "cpu")(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jexport.load_exported(jpath)(x)), **ACT)
    header = texport.export_model(path, q, TCFG, SCHED, batch=[2, 4], dtype=torch.bfloat16,
                                  platform="cuda", act_scales=scales)
    assert ActScales.from_dict(header["act_scales"]) == scales
    with open(path, "rb") as f:
        assert texport.read_header(f.read())[0]["act_scales"] == header["act_scales"]


def test_auto_resolves_against_the_target_platform(tmp_path):
    """A host without a card writes a ``cuda`` artifact that routes the
    kernels where they take the config (C = 128, head_dim 64, bf16), the
    torch route with its reason where not; a ``cuda`` artifact does not load
    on the CPU; ``impl="cuda"`` cannot target the CPU."""
    cfg = tvit.ViTConfig(img_size=16, patch_size=8, embed_dim=128, depth=1, num_heads=2,
                         num_classes=5)
    params = tvit.init_params(torch.Generator().manual_seed(0), cfg)
    path = str(tmp_path / "cuda.rajni")
    header = texport.export_model(path, params, cfg, None, batch=[8, 32], platform="cuda")
    assert header["routes"] == {"8": {"impl": "cuda", "reason": ""},
                                "32": {"impl": "cuda", "reason": ""}}
    with pytest.raises(ValueError, match="platform 'cuda'"):
        texport.load_exported(path, device="cpu")
    header = texport.export_model(path, params, cfg, None, batch=8, dtype=torch.float32,
                                  platform="cuda")
    assert header["routes"]["8"] == {"impl": "torch",
                                     "reason": "float32 activations (the kernels take bfloat16)"}
    header = texport.export_model(path, params_from_numpy(jax.tree.map(
        np.asarray, jvit.init_params(jax.random.key(0), CFG))), TCFG, None, batch=2,
        platform="cuda")
    assert header["routes"]["2"] == {"impl": "torch", "reason": "C=32 is not a multiple of 128"}
    assert texport.export_model(path, params, cfg, batch=2, platform="cpu")["routes"]["2"][
        "impl"] == "torch"
    with pytest.raises(ValueError, match="cannot target platform='cpu'"):
        texport.export_model(path, params, cfg, batch=2, impl="cuda", platform="cpu")


def test_jax_artifacts_are_refused_by_name(jax_artifacts):
    with pytest.raises(ValueError, match="RAJNI-BUCKETS"):
        texport.load_exported(jax_artifacts["buckets"], device="cpu")
    for form in ("fixed", "dynamic"):
        with pytest.raises(ValueError, match="headerless file is what rajni_tpu.export writes"):
            texport.load_exported(jax_artifacts[form], device="cpu")


def test_export_validation(tmp_path, jax_params):
    tp, path = params_from_numpy(jax_params), str(tmp_path / "x.rajni")
    for batch, match in (([0, 4], "positive"), ([], "positive"), ("many", "batch must"),
                         (2.5, "batch must"), (0, "batch must")):
        with pytest.raises(ValueError, match=match):
            texport.export_model(path, tp, TCFG, None, batch=batch, platform="cpu")
    with pytest.raises(ValueError, match="platform"):
        texport.export_model(path, tp, TCFG, None, batch=2, platform="tpu")
    with pytest.raises(ValueError, match="dtype"):
        texport.export_model(path, tp, TCFG, None, batch=2, dtype=torch.float16,
                             platform="cpu")
    assert texport.parse_batch("8,32,256") == [8, 32, 256]
    assert texport.parse_batch("dynamic") == "dynamic" and texport.parse_batch("4") == 4


@pytest.fixture()
def toy_names():
    """The narrow configs under model names in both packages' registries."""
    oracle_cfg = tvit.ViTConfig(**{f.name: getattr(ORACLE_CFG, f.name)
                                   for f in dataclasses.fields(tvit.ViTConfig)})
    added = {"_export_toy": (CFG, TCFG), "_export_oracle": (ORACLE_CFG, oracle_cfg)}
    for name, (j, t) in added.items():
        jvit.VARIANTS[name], tvit.VARIANTS[name] = j, t
    yield
    for name in added:
        del jvit.VARIANTS[name], tvit.VARIANTS[name]


def test_cli_on_a_timm_pth_and_a_msgpack(tmp_path, rng, capsys, toy_names):
    """The CLI on a timm ``.pth`` (an MAE-style pooled head, adapted from its
    keys) at buckets 2,4 against the oracle's logits, and on a distilled
    msgpack written by JAX under the base name (adapted from its leaves),
    dynamic, against JAX's forward."""
    torch.manual_seed(3)
    ocfg = dataclasses.replace(ORACLE_CFG, global_pool="avg")
    oracle = TorchOracleViT(ocfg).eval()
    pth = str(tmp_path / "mae.pth")
    torch.save({"model": oracle.state_dict()}, pth)
    out = str(tmp_path / "mae.rajni")
    texport.main([pth, out, "--model", "_export_oracle", "--batch", "2,4", "--dtype", "float32",
                  "--platform", "cpu"])
    printed = capsys.readouterr().out
    assert "global_pool=avg" in printed and "route: torch (platform cpu)" in printed
    assert "exported _export_oracle" in printed
    serve = texport.load_exported(out, "cpu")
    assert serve.buckets == [2, 4] and serve.config.fc_norm_resolved
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(serve(x).numpy(), want, **ACT)

    dcfg = dataclasses.replace(CFG, distilled=True)
    jp = jvit.init_params(jax.random.key(11), dcfg, jnp.float32)
    ckpt, out = str(tmp_path / "d.msgpack"), str(tmp_path / "d.rajni")
    jio.save_params(ckpt, jp)
    sched = tmp_path / "s.json"
    sched.write_text(json.dumps({"1": {"keep_ratio": 0.5}}))
    texport.main([ckpt, out, "--model", "_export_toy", "--schedule", str(sched), "--batch",
                  "dynamic", "--dtype", "float32", "--kernels", "torch", "--platform", "cpu"])
    assert "distilled=True" in capsys.readouterr().out
    serve = texport.load_exported(out, "cpu")
    assert serve.dynamic_batch and serve.input_spec.shape[0] is None
    jforward = jax.jit(jvit.vit_forward, static_argnums=(2, 3))
    for b in (1, 3):
        x = _images(rng, b)
        want = jforward(jp, jnp.asarray(x), dcfg, jvit.normalize_schedule(SCHED, 2))
        np.testing.assert_allclose(serve(x).numpy(), np.asarray(want), **ACT)
    # the port's msgpack of the artifact's params is JAX's layout
    tio.save_params(str(tmp_path / "back.msgpack"), serve.model.params)
    back = jio.load_params(str(tmp_path / "back.msgpack"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
