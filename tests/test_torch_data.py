"""The port's image pipeline (``rajni_tpu_torch/data/pipeline.py`` and
``data/native.py``) against the JAX package's, on the CPU.

The same PIL images (numpy-made, seeded) go through both packages: class
discovery, the geometry, the three host tiers (normalized float32 through
PIL, the uint8 crop, the decode-only canvas) and the loader's batches are
equal bit for bit. The port's C++ tier is held to PIL at
tests/test_native.py's tolerance (±1.5/255 before the normalize), and builds
from three processes at once into one empty directory. The JAX package's C++
library is never called here: its loaders run with ``use_native=False``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rajni_tpu.data import pipeline as jpipe
from rajni_tpu_torch.data import native as tnative
from rajni_tpu_torch.data import pipeline as tpipe

ROOT = Path(__file__).resolve().parent.parent
# tests/test_native.py's tolerance: ±1.5/255 before the normalize
TOL = 1.5 / 255.0 / float(tpipe.IMAGENET_STD.min())
# (h, w): portrait, landscape, square, upscaled, larger than the 512 canvas
SHAPES = [(500, 375), (375, 500), (300, 300), (150, 200), (600, 800)]


def _image(rng, h, w) -> Image.Image:
    """Smooth gradients plus noise: real-image-like content with edges."""
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    base = 255 * (0.5 * y + 0.5 * x) * np.array([1.0, 0.7, 0.4])
    arr = np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)
    return Image.fromarray(arr, "RGB")


def _folder(tmp_path, rng, per_class=3, classes=("b_cls", "a_cls", "c_cls")) -> Path:
    root = tmp_path / "data"
    for ci, c in enumerate(classes):
        d = root / c
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = SHAPES[(ci + i) % len(SHAPES)]
            _image(rng, h // 2, w // 2).save(d / f"img{i}.{'png' if i % 2 else 'jpg'}")
        (d / "notes.txt").write_text("not an image")
    (root / "stray.jpg").write_bytes(b"")  # files at the root are not samples
    return root


def test_find_classes_and_samples_match_jax(tmp_path, rng):
    root = _folder(tmp_path, rng)
    assert tpipe.find_classes(str(root)) == jpipe.find_classes(str(root))
    t, j = tpipe.ImageFolder(str(root)), jpipe.ImageFolder(str(root))
    assert t.classes == j.classes == ["a_cls", "b_cls", "c_cls"]
    assert t.samples == j.samples and len(t) == 9
    with pytest.raises(FileNotFoundError):
        tpipe.find_classes(str(tmp_path / "data" / "a_cls"))


@pytest.mark.parametrize("img_size", [224, 384])
def test_resize_crop_geometry_matches_jax(img_size):
    resize = tpipe._default_resize(img_size, None)
    assert resize == jpipe._default_resize(img_size, None)
    for w in range(1, 900, 13):
        for h in range(1, 900, 17):
            assert (tpipe.resize_crop_geometry(w, h, img_size, resize)
                    == jpipe.resize_crop_geometry(w, h, img_size, resize)), (w, h)
    # round-half-even: (257 - 224) / 2 = 16.5 crops at 16
    assert tpipe.resize_crop_geometry(257, 256, 224, 256)[2] == 16


@pytest.mark.parametrize("h,w", SHAPES, ids=["portrait", "landscape", "square", "upscaled",
                                             "past the canvas"])
def test_host_tiers_bitwise_equal_to_jax(rng, h, w):
    im = _image(rng, h, w)
    for size in (224, 96):
        np.testing.assert_array_equal(tpipe.preprocess(im, size), jpipe.preprocess(im, size))
        np.testing.assert_array_equal(tpipe.preprocess_u8(im, size),
                                      jpipe.preprocess_u8(im, size))
    canvas, hw = tpipe.decode_to_canvas(im, 512)
    jcanvas, jhw = jpipe.decode_to_canvas(im, 512)
    np.testing.assert_array_equal(canvas, jcanvas)
    np.testing.assert_array_equal(hw, jhw)
    assert canvas.dtype == np.uint8 and hw.dtype == np.int32


@pytest.mark.parametrize("output", ["float32", "uint8", "canvas"])
@pytest.mark.parametrize("workers", [1, 3])
def test_dataloader_batches_equal_to_jax(tmp_path, rng, output, workers):
    """Serial and threaded, a partial last batch (9 images in batches of 4),
    canvas batches as ``(canvas, sizes)`` tuples."""
    root = str(_folder(tmp_path, rng))
    kw = dict(img_size=64, output=output, canvas=200, use_native=False)
    t = tpipe.DataLoader(tpipe.ImageFolder(root, **kw), batch_size=4, num_workers=workers)
    j = jpipe.DataLoader(jpipe.ImageFolder(root, **kw), batch_size=4, num_workers=workers)
    got, want = list(t), list(j)
    assert len(t) == len(got) == len(want) == 3
    assert [len(lb) for _, lb in got] == [4, 4, 1]
    for (gx, gl), (wx, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert isinstance(gx, tuple) == (output == "canvas")
        for a, b in zip(gx if isinstance(gx, tuple) else (gx,),
                        wx if isinstance(wx, tuple) else (wx,)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w", [(500, 375), (375, 500), (224, 224), (1024, 100), (257, 256)])
def test_native_tier_matches_pil(rng, h, w):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = tpipe.preprocess(Image.fromarray(rgb, "RGB"), 224, 256)
    got = tnative.preprocess_native(rgb, 224, 256, tpipe.IMAGENET_MEAN, tpipe.IMAGENET_STD)
    assert got.shape == want.shape == (224, 224, 3)
    diff = np.abs(got - want)
    assert diff.max() <= TOL, f"max diff {diff.max():.5f} > {TOL:.5f}"
    assert (diff == 0).mean() > 0.5


def test_image_folder_names_the_host_tier(tmp_path, rng, monkeypatch):
    root = str(_folder(tmp_path, rng, per_class=1))
    ds = tpipe.ImageFolder(root, img_size=64)
    assert ds.host_tier() == "native"
    native = ds.load(0)[0]
    monkeypatch.setenv("RAJNI_NATIVE", "0")
    assert ds.host_tier() == "PIL" and not tnative.available()
    pil = ds.load(0)[0]
    np.testing.assert_array_equal(pil, jpipe.ImageFolder(root, img_size=64,
                                                         use_native=False).load(0)[0])
    assert np.abs(native - pil).max() <= TOL
    assert tpipe.ImageFolder(root, img_size=64, output="canvas").host_tier() == "canvas"


_BUILD_AND_RUN = """
import sys
import numpy as np
from rajni_tpu_torch.data import native
lib = native._bind(native.build(sys.argv[1]))
rgb = np.random.default_rng(0).integers(0, 256, (40, 30, 3), dtype=np.uint8)
native._lib = lib
out = native.preprocess_native(rgb, 16, 18, np.zeros(3, np.float32), np.ones(3, np.float32))
print(out.shape, float(out.min()) >= 0.0)
"""


def test_three_processes_build_into_one_empty_directory(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_RUN, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "(16, 16, 3) True"
    lib = tnative.library_path(tmp_path)
    assert lib.is_file()
    assert sorted(f.name for f in lib.parent.iterdir()) == [".lock", lib.name]
