"""The port's training augmentation (``rajni_tpu_torch/data/augment.py``,
``data/randaug.py``) against the JAX package's, given JAX's draws: the
RandomResizedCrop box (fallback included), the crop through the crop-box
bicubic weights with its flip, and the normalize; each of the 15 RandAugment ops at
three levels, RandomErasing in its three modes, and the policy parser; and
that the policy's layers, grouped by op, give each image its own ops.

The JAX functions run eagerly at 16-32 px (a jitted ``lax.switch`` over 15
ops costs seconds to compile). JAX's draws are re-made in the test from the
keys JAX splits, and fed to the port's apply halves. Everything is exact in
the uint8 domain (the normalized floats to an fp32 rounding), but the geometric ops (rotate, shear, translate), whose cos/sin and affine
sums may round a sample the other way: within one uint8 level on under 1%
of the values.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.data import augment as jaug
from rajni_tpu.data import randaug as jra
from rajni_tpu_torch.data import augment as taug
from rajni_tpu_torch.data import randaug as tra
from rajni_tpu_torch.utils.rng import host_rng

GEOMETRIC = {3, 11, 12, 13, 14}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_draws(key, scale=taug.DEFAULT_SCALE, ratio=taug.DEFAULT_RATIO):
    """The uniforms JAX's ``_rrc_box`` draws from ``key``."""
    k_area, k_ratio, k_top, k_left = jax.random.split(key, 4)
    return (jax.random.uniform(k_area, (10,), minval=scale[0], maxval=scale[1]),
            jax.random.uniform(k_ratio, (10,), minval=math.log(ratio[0]),
                               maxval=math.log(ratio[1])),
            jax.random.uniform(k_top), jax.random.uniform(k_left))


def _canvas(rng, sizes, S):
    canvas = np.zeros((len(sizes), S, S, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return canvas


def test_rrc_box_matches_jax():
    """Boxes from JAX's draws, over ordinary sizes and extreme aspects that
    fall back to the clamped centre crop."""
    sizes = [(40, 30), (31, 64), (64, 64), (6, 200), (200, 7), (3, 3)]
    keys = jax.random.split(jax.random.key(1), 12)
    hs, ws = ([sizes[i % len(sizes)][j] for i in range(12)] for j in (0, 1))
    want = np.stack([np.asarray(v) for v in jax.vmap(lambda k, h, w: jaug._rrc_box(
        k, h, w, taug.DEFAULT_SCALE, taug.DEFAULT_RATIO))(keys, jnp.array(hs), jnp.array(ws))],
                    1).tolist()
    draws = jax.vmap(_box_draws)(keys)
    got = taug._rrc_box(torch.tensor(hs), torch.tensor(ws),
                        *(torch.from_numpy(np.array(d)) for d in draws))
    assert np.stack([g.numpy() for g in got], 1).tolist() == want
    assert any(t == ((h - ch) // 2) and ch == h for (t, _, ch, _), h in zip(want, hs))


def test_crop_flip_normalize_match_jax():
    """JAX's ``augment_on_device`` against the port's apply half given its
    boxes and flips: the same uint8 crops, exactly, and their normalized
    values within an fp32 rounding (XLA fuses the normalize's ops)."""
    rng = np.random.default_rng(2)
    sizes = [(40, 30), (24, 50), (50, 50), (18, 20)]
    canvas = _canvas(rng, sizes, 56)
    key = jax.random.key(2)
    want = jaug.augment_on_device(jnp.asarray(canvas), jnp.asarray(np.array(sizes, np.int32)),
                                  key, crop=24, dtype=jnp.float32)
    parts = {"area": [], "log_ratio": [], "u_top": [], "u_left": [], "flip": []}
    for k in jax.random.split(key, len(sizes)):
        k_box, k_flip, _, _ = jax.random.split(k, 4)
        for name, v in zip(("area", "log_ratio", "u_top", "u_left"), _box_draws(k_box)):
            parts[name].append(np.asarray(v))
        parts["flip"].append(bool(jax.random.bernoulli(k_flip)))
    draws = {k: np.stack(v) for k, v in parts.items()}
    draws.update(ratio=taug.DEFAULT_RATIO, erase=None, rand_augment=None)
    got = taug.augment_apply(torch.from_numpy(canvas), torch.tensor(sizes), draws, 24,
                             torch.float32)
    crop = taug.crop_and_flip(torch.from_numpy(canvas), torch.tensor(sizes), draws, 24)
    assert any(parts["flip"]) and not all(parts["flip"])
    from rajni_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD

    want_crop = np.round((np.asarray(want) * IMAGENET_STD + IMAGENET_MEAN) * 255.0)
    np.testing.assert_array_equal(crop.numpy(), want_crop)  # exact in the uint8 domain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _jax_ra_draws(key, num_layers, magnitude, mstd, mmax, prob, increasing):
    """JAX's per-layer RandAugment draws (``rand_augment_apply``): op, gate,
    level and the sign coin the op's ``_neg`` takes from ``k_op``."""
    op, gate, level, neg = [], [], [], []
    for layer in range(num_layers):
        k_choice, k_gate, k_mag, k_op = jax.random.split(jax.random.fold_in(key, layer), 4)
        op.append(int(jax.random.randint(k_choice, (), 0, 15)))
        gate.append(bool(jax.random.bernoulli(k_gate, prob)))
        lv = magnitude + mstd * jax.random.normal(k_mag) if mstd > 0 else jnp.float32(magnitude)
        level.append(np.float32(jnp.clip(lv, 0.0, mmax)))
        neg.append(bool(jax.random.bernoulli(k_op)))
    return np.array(op), np.array(gate), np.array(level, np.float32), np.array(neg)


@pytest.mark.parametrize("op", range(15))
def test_rand_augment_op_matches_jax(op):
    """Each op at three levels (increasing maps, and the plain maps where they
    differ), on two images, with the sign JAX's op draws."""
    rng = np.random.default_rng(op)
    imgs = rng.integers(0, 256, (2, 20, 24, 3)).astype(np.float32)
    imgs[1] = np.clip(np.round(imgs[1] * 0.3 + 60), 0, 255)  # a low-contrast image
    for increasing in ((True, False) if op in (4, 5, 7, 8, 9, 10) else (True,)):
        jops, tops = jra._op_table(jra.DEFAULT_FILL, increasing), tra._op_table(
            tra.DEFAULT_FILL, increasing)
        want = None
        for level in (0.0, 4.5, 9.0):
            keys = jax.random.split(jax.random.key(op), 2)
            if want is None or op > 2:  # AutoContrast, Equalize, Invert take no level
                want = np.stack([np.asarray(jops[op](jnp.asarray(im), jnp.float32(level), k))
                                 for im, k in zip(imgs, keys)])
            neg = torch.tensor([bool(jax.random.bernoulli(k)) for k in keys])
            got = tops[op](torch.from_numpy(imgs), torch.full((2,), level), neg).numpy()
            if op in GEOMETRIC:
                diff = np.abs(got - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (level, diff.max())
            else:
                np.testing.assert_array_equal(got, want)


def test_rand_augment_layers_give_each_image_its_own_op():
    """The policy on a batch, grouped by drawn op, equals each image taken
    alone through its own drawn ops, gates, levels and signs, layer after
    layer (the draws follow ``(seed, tag, step)``; the ops are held to JAX's
    above)."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (8, 16, 16, 3)).astype(np.float32)
    kw = tra.parse_rand_augment("rand-m7-mstd0.5-n3-inc1")
    draws = tra.draw_rand_augment(host_rng(0, 1, 2), 8, **kw)
    got = tra.rand_augment_apply(torch.from_numpy(imgs), draws, True)
    ops = tra._op_table(tra.DEFAULT_FILL, True)
    for b in range(8):
        x = torch.from_numpy(imgs[b:b + 1])
        for layer in range(3):
            if draws["gate"][b, layer]:
                x = ops[draws["op"][b, layer]](x, torch.tensor(draws["level"][b, layer:layer + 1]),
                                               torch.tensor(draws["neg"][b, layer:layer + 1]))
        assert torch.equal(got[b:b + 1], x)
    assert len(set(draws["op"][draws["gate"]].tolist())) > 3


@pytest.mark.parametrize("mode, count", [("pixel", 1), ("rand", 2), ("const", 3)])
def test_random_erasing_matches_jax(mode, count):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 24, 20, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), 5)
    want = np.stack([np.asarray(jra.random_erasing(jnp.asarray(im), k, prob=0.7, mode=mode,
                                                   count=count)) for im, k in zip(x, keys)])
    lo, hi = math.log(0.3), math.log(1 / 0.3)
    draws = {"mode": mode, "gate": [], "area": [], "log_aspect": [], "u_top": [], "u_left": [],
             "fill": [], "noise": []}
    for k in keys:
        k_gate, k_body = jax.random.split(k)
        draws["gate"].append(bool(jax.random.bernoulli(k_gate, 0.7)))
        per = {n: [] for n in ("area", "log_aspect", "u_top", "u_left", "fill", "noise")}
        for e in range(count):
            k_area, k_ar, k_top, k_left, k_fill = jax.random.split(jax.random.fold_in(k_body, e),
                                                                   5)
            per["area"].append(np.asarray(jax.random.uniform(k_area, (10,), minval=0.02,
                                                             maxval=1 / 3)))
            per["log_aspect"].append(np.asarray(jax.random.uniform(k_ar, (10,), minval=lo,
                                                                   maxval=hi)))
            per["u_top"].append(np.float32(jax.random.uniform(k_top)))
            per["u_left"].append(np.float32(jax.random.uniform(k_left)))
            per["fill"].append(np.float32(jax.random.normal(k_fill, ())))
            per["noise"].append(np.asarray(jax.random.normal(k_fill, x.shape[1:])))
        for n, v in per.items():
            draws[n].append(np.stack(v))
    draws = {k: v if k == "mode" else np.stack(v) for k, v in draws.items()}
    draws["noise"] = torch.from_numpy(draws["noise"])
    got = tra.random_erasing_apply(torch.from_numpy(x), draws).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).any()


def test_parse_rand_augment_matches_jax():
    for cfg in ("rand-m9-mstd0.5-inc1", "rand-m7-n3-p0.8-mstd101-mmax12", "rand-m5"):
        assert tra.parse_rand_augment(cfg) == jra.parse_rand_augment(cfg)
    for bad in ("randx", "rand-w3", "rand-m"):
        with pytest.raises(ValueError):
            tra.parse_rand_augment(bad)


def test_augment_on_device_replays_its_stream():
    """The stream is a pure function of (seed, step): the same step gives
    the same batch, another step another."""
    rng = np.random.default_rng(3)
    sizes = torch.tensor([(40, 30), (24, 50)])
    canvas = torch.from_numpy(_canvas(rng, sizes.tolist(), 56))
    kw = dict(crop=24, dtype=torch.float32, rand_augment="rand-m9-mstd0.5-inc1",
              erase=(1.0, "pixel", 1))
    a = taug.augment_on_device(canvas, sizes, 1, 5, **kw)
    assert torch.equal(a, taug.augment_on_device(canvas, sizes, 1, 5, **kw))
    assert not torch.equal(a, taug.augment_on_device(canvas, sizes, 1, 6, **kw))
    draws = taug.draw_augment(host_rng(1, taug._AUGMENT_TAG, 5), 2, rand_augment=kw[
        "rand_augment"], erase=kw["erase"], crop=24, noise_generator=torch.Generator())
    assert draws["erase"]["noise"].shape == (2, 1, 24, 24, 3)
