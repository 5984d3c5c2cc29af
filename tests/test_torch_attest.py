"""The port's accuracy attestation (``rajni_tpu_torch/attest.py``) and the
eval CLI's ``--artifact`` (``rajni_tpu_torch/run.py``) against the JAX
package's, on the CPU.

Fixtures written by each package are read by the other, field for field.
The committed reference fixture's first images replay through the port's
``check_fixture`` (its msgpack read by the port) and through JAX's, in fp32:
the same top-1 agreement, deviations within 1e-5 of JAX's. A self-fixture
captured by the port replays exactly (and in padded chunks within 1e-5), on
the images JAX captures for the same seed. The CLI's exit codes, ``--quantize
--act_scales`` on the kernel route (the kernels' plain versions here), and
``run.main(["--artifact", ...])`` with the flags it rejects. A narrow model
(tests/test_export.py's ``CFG``) stands under a registered name in both
packages.
"""

from __future__ import annotations

import dataclasses
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import attest as jattest
from rajni_tpu.models import vit as jvit
from rajni_tpu.params import io as jio
from rajni_tpu_torch import attest as tattest
from rajni_tpu_torch import params_from_numpy, run
from rajni_tpu_torch.export import export_model
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params import io as tio
from rajni_tpu_torch.quant import calibrate_act_scales
from tests.test_export import CFG

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "reference_vit_tiny_schedulejson"
TOY = "_attest_port_toy"
SCHED = {1: {"keep_ratio": 0.5, "update": True}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def toy():
    """The narrow config under ``TOY`` in both registries; JAX params."""
    tcfg = tvit.ViTConfig(**{f.name: getattr(CFG, f.name)
                             for f in dataclasses.fields(tvit.ViTConfig)})
    jvit.VARIANTS[TOY], tvit.VARIANTS[TOY] = CFG, tcfg
    yield jax.tree.map(np.asarray, jvit.init_params(jax.random.key(2), CFG, jnp.float32))
    del jvit.VARIANTS[TOY], tvit.VARIANTS[TOY]


def _assert_same_fixture(a: dict, b: dict) -> None:
    for k in ("images", "logits"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["model"], a["schedule"], a["source"]) == (b["model"], b["schedule"], b["source"])


def test_fixtures_cross_read(tmp_path, rng):
    images = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    logits = rng.standard_normal((4, 6)).astype(np.float32)
    for sched in ({1: {"keep_ratio": 0.5, "update": True}, 3: {"keep_ratio": 0.9}}, None):
        jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        jattest.save_fixture(jpath, images, logits, "vit_tiny_patch16_224", sched, "jax")
        tattest.save_fixture(tpath, images, logits, "vit_tiny_patch16_224", sched, "jax")
        for path in (jpath, tpath):
            _assert_same_fixture(tattest.load_fixture(path), jattest.load_fixture(path))
        _assert_same_fixture(tattest.load_fixture(jpath), jattest.load_fixture(tpath))
        with np.load(jpath) as zj, np.load(tpath) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
                np.testing.assert_array_equal(zj[k], zt[k])
    with pytest.raises(ValueError, match="NHWC"):
        tattest.save_fixture(str(tmp_path / "x.npz"), images[0], logits, "m")


def test_reference_fixture_report_equals_jax():
    """The reference program's fixture (vit_tiny, its schedule), first four
    images, replayed by both packages on its msgpack."""
    full = tattest.load_fixture(str(FIXTURE) + ".npz")
    fix = {**full, "images": full["images"][:4], "logits": full["logits"][:4]}
    got = tattest.check_fixture(fix, tio.load_params(str(FIXTURE) + ".msgpack"), device="cpu")
    want = jattest.check_fixture(fix, jio.load_params(str(FIXTURE) + ".msgpack"))
    assert got["n"] == want["n"] == 4 and got["model"] == want["model"]
    assert got["top1_agreement"] == want["top1_agreement"] == 1.0
    assert abs(got["max_abs_diff"] - want["max_abs_diff"]) <= 1e-5
    assert abs(got["mean_abs_diff"] - want["mean_abs_diff"]) <= 1e-5


def test_self_fixture_replays_exactly(tmp_path, toy):
    params = params_from_numpy(toy)
    path, jpath = str(tmp_path / "self.npz"), str(tmp_path / "jax.npz")
    assert tattest.capture_self_fixture(path, params, TOY, SCHED, n=5, seed=1,
                                        device="cpu") == {"n": 5, "path": path}
    jattest.capture_self_fixture(jpath, toy, TOY, SCHED, n=5, seed=1)
    mine, theirs = tattest.load_fixture(path), jattest.load_fixture(jpath)
    np.testing.assert_array_equal(mine["images"], theirs["images"])  # one numpy stream
    np.testing.assert_allclose(mine["logits"], theirs["logits"], rtol=1e-4, atol=1e-5)
    assert mine["source"] == "rajni-tpu-torch self float32 torch"
    report = tattest.check_fixture(path, params, device="cpu")
    assert report["top1_agreement"] == 1.0 and report["max_abs_diff"] == 0.0
    # in chunks of 2, the last padded: the CPU's fp32 products block by the
    # row count, so the bits may move (not JAX's XLA here); the argmax not
    report = tattest.check_fixture(path, params, batch=2, device="cpu")
    assert report["top1_agreement"] == 1.0 and report["max_abs_diff"] <= 1e-5
    # JAX's impl names are taken, and JAX reads the port's fixture
    assert tattest.check_fixture(jpath, params, impl="xla", device="cpu")["top1_agreement"] == 1.0
    assert jattest.check_fixture(path, toy)["top1_agreement"] == 1.0


def test_attest_cli_exit_codes(tmp_path, capsys, toy):
    params = params_from_numpy(toy)
    fix, ckpt = str(tmp_path / "f.npz"), str(tmp_path / "p.msgpack")
    tattest.capture_self_fixture(fix, params, TOY, SCHED, n=3, seed=3, device="cpu")
    tio.save_params(ckpt, params)
    tattest.main([fix, "--checkpoint", ckpt, "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert report["top1_agreement"] == 1.0 and report["dtype"] == "float32"
    with pytest.raises(SystemExit, match="< 1.01"):  # above what can be reached
        tattest.main([fix, "--checkpoint", ckpt, "--device", "cpu", "--min_agreement", "1.01"])
    capsys.readouterr()
    other = str(tmp_path / "other.msgpack")
    jio.save_params(other, jvit.init_params(jax.random.key(9), CFG, jnp.float32))
    with pytest.raises(SystemExit):
        tattest.main([fix, "--checkpoint", other, "--device", "cpu", "--min_agreement", "0.999"])
    capsys.readouterr()
    # the static-scale int8 configuration that serves, on the kernel route
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    sfile = str(tmp_path / "scales.json")
    calibrate_act_scales(params, x, tvit.VARIANTS[TOY], SCHED).save(sfile)
    tattest.main([fix, "--checkpoint", ckpt, "--quantize", "--act_scales", sfile, "--kernels",
                  "cuda", "--device", "cpu", "--min_agreement", "0.0"])
    assert '"top1_agreement"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="requires --quantize"):
        tattest.main([fix, "--checkpoint", ckpt, "--act_scales", sfile, "--device", "cpu"])


def _run(argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.main(argv)
    return buf.getvalue()


def test_eval_cli_artifact(tmp_path, toy):
    params = params_from_numpy(toy)
    paths = {}
    for form, batch in (("buckets", [2, 4]), ("fixed", 3)):
        paths[form] = str(tmp_path / f"{form}.rajni")
        export_model(paths[form], params, tvit.VARIANTS[TOY], SCHED, batch=batch,
                     dtype=torch.float32, platform="cpu")
    base = ["--synthetic", "2", "--batch_size", "4", "--device", "cpu", "--warmup", "1",
            "--no-progress"]
    out = _run(["--artifact", paths["buckets"], *base])
    counts = jvit.model_stats(CFG, jvit.normalize_schedule(SCHED, CFG.depth))["token_counts"]
    assert f"Artifact {paths['buckets']}: 16px, batch buckets [2, 4], float32" in out
    assert "route: torch" in out.splitlines()
    assert f"Token counts per block: {counts}" in out
    assert "Artifact model: top-1" in out
    out = _run(["--artifact", paths["fixed"], *base])
    assert "NOTE: loader batch follows the artifact (3), not --batch_size (4)" in out
    for flags in (["--checkpoint", "x.msgpack"], ["--schedule", "s.json"], ["--quantize"],
                  ["--quantize", "--calibrate", "1"], ["--compare_base"],
                  ["--kernels", "torch"]):
        with pytest.raises(ValueError, match="--artifact evaluates a baked program"):
            _run(["--artifact", paths["buckets"], *base, *flags])
    with pytest.raises(ValueError, match="--preprocess host"):
        _run(["--artifact", paths["buckets"], *base[:-1], "--preprocess", "device"])
