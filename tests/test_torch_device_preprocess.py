"""The port's on-device preprocessing (``rajni_tpu_torch/data/device.py``)
against the JAX package's and the host pipeline, on the CPU.

``normalize_images`` is bit for bit JAX's and the host's ``(x / 255 -
mean) / std``. ``preprocess_on_device`` against JAX's on the same canvases in
fp32: XLA on the CPU fuses the last normalize's ``x · (1/255) - mean`` into one
FMA, which the port's eager ops round twice, so the two differ by float
rounding (at most 1.4e-5 of a uint8 level measured), and where a product's
summation order moves a value across a rounding edge between the passes by
one level: tolerance, every pixel within one uint8 level and at most 1e-3 of
them past 1e-3 of a level. Against the host PIL pipeline: within one level a
pass (2 levels), at most 1% of pixels apart, on canvases that fit the images
(tests/test_device_preprocess.py's bound, in levels).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from rajni_tpu.data import device as jdev
from rajni_tpu.data import pipeline as jpipe
from rajni_tpu_torch.data import device as tdev
from rajni_tpu_torch.data import pipeline as tpipe

STD = tpipe.IMAGENET_STD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(rng, h, w) -> Image.Image:
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    base = 255 * (0.5 * y + 0.5 * x) * np.array([1.0, 0.7, 0.4])
    return Image.fromarray(np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8))


def _levels(a, b) -> np.ndarray:
    """Normalized differences in uint8 levels."""
    return np.abs(a - b) * STD * 255.0


def test_normalize_images_bitwise_jax_and_host(rng):
    u8 = rng.integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
    got = tdev.normalize_images(torch.from_numpy(u8), torch.float32).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdev.normalize_images(jnp.asarray(u8),
                                                                        jnp.float32)))
    np.testing.assert_array_equal(
        got, (u8.astype(np.float32) / 255.0 - tpipe.IMAGENET_MEAN) / tpipe.IMAGENET_STD)
    bf16 = tdev.normalize_images(torch.from_numpy(u8))
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, torch.from_numpy(got).to(torch.bfloat16))


def test_normalize_of_the_uint8_crop_is_the_host_pipeline(rng):
    for h, w in ((300, 200), (120, 160)):
        im = _image(rng, h, w)
        u8 = tpipe.preprocess_u8(im, 64)[None].copy()
        got = tdev.normalize_images(torch.from_numpy(u8), torch.float32).numpy()[0]
        np.testing.assert_array_equal(got, tpipe.preprocess(im, 64))


# (canvas, crop, resize, image sizes): downscales both ways, square, upscales
CASES = {
    "narrow": (256, 64, 73, [(250, 187), (187, 250), (150, 150), (50, 40), (30, 60),
                             (256, 200)]),
    "vit_b": (512, 224, 256, [(500, 375), (375, 500), (333, 500), (150, 200)]),
}


def _canvases(rng, S, shapes):
    ims = [_image(rng, h, w) for h, w in shapes]
    cs = [tpipe.decode_to_canvas(im, S) for im in ims]
    return ims, np.stack([c for c, _ in cs]), np.stack([s for _, s in cs])


@pytest.mark.parametrize("case", list(CASES))
def test_preprocess_on_device_matches_jax_and_host(rng, case):
    S, crop, resize, shapes = CASES[case]
    ims, canvas, sizes = _canvases(rng, S, shapes)
    got = tdev.preprocess_on_device(torch.from_numpy(canvas), torch.from_numpy(sizes),
                                    crop=crop, resize=resize, dtype=torch.float32).numpy()
    want = np.asarray(jdev.preprocess_on_device(jnp.asarray(canvas), jnp.asarray(sizes),
                                                crop=crop, resize=resize, dtype=jnp.float32))
    assert got.shape == want.shape == (len(shapes), crop, crop, 3)
    lev = _levels(got, want)
    assert lev.max() <= 1.0 + 1e-4, lev.max()
    assert (lev > 1e-3).mean() <= 1e-3, (lev > 1e-3).mean()
    host = np.stack([jpipe.preprocess(im, crop, resize) for im in ims])
    lev = _levels(got, host)
    assert lev.max() <= 2.0 + 1e-4, lev.max()
    assert (lev > 1e-3).mean() <= 1e-2, (lev > 1e-3).mean()


def test_preprocess_on_device_bf16_is_the_fp32_result_rounded(rng):
    _, canvas, sizes = _canvases(rng, 128, [(100, 80), (60, 120)])
    args = (torch.from_numpy(canvas), torch.from_numpy(sizes))
    f32 = tdev.preprocess_on_device(*args, crop=48, resize=55, dtype=torch.float32)
    assert torch.equal(tdev.preprocess_on_device(*args, crop=48, resize=55),
                       f32.to(torch.bfloat16))


def test_resample_rows_match_jax_weights():
    """The weight matrices of one upscale and one downscale, rows summing to 1."""
    for in_size, out_size, offset in ((50, 73, 4), (250, 73, 0), (187, 99, 17)):
        got = tdev._resample_rows(torch.tensor([in_size]), torch.tensor([out_size]),
                                  torch.tensor([offset]), 64, 256)[0].numpy()
        want = np.asarray(jdev._resample_rows(jnp.int32(in_size), jnp.int32(out_size),
                                              jnp.int32(offset), 64, 256))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
        assert (got[:, in_size:] == 0).all()
