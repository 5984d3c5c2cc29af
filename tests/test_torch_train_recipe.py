"""The fine-tuning recipe of the port's trainer against the JAX package:
layer decay and EMA in optax's chain under ``grad_accum``, mixup and CutMix
given JAX's draws, the mixed and distillation losses, the synthetic batch,
saving and resuming (bit for bit on the CPU), and the CLI on an image
folder: every recipe flag, the ``--shuffle`` order, ``--resume``'s
fast-forward, and JAX's argument checks.

Tolerances: the optimizer within 1e-6 on the params and the EMA (as
tests/test_torch_train.py holds AdamW), the losses within 1e-6 relative,
the mixed images and CutMix's box and λ exactly; resuming exactly.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import train as jtrain
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch import train as ttrain
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params.from_jax import params_to_numpy
from rajni_tpu_torch.params.io import load_params, save_params

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2, num_classes=5,
            use_layer_scale=True)  # one block: the optax chain's jit compiles per leaf
MODEL = "deit_tiny_patch16_32"  # a timm name: C=192, depth 12, 5 tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jp(extra=None, seed=0):
    cfg = tvit.ViTConfig(**TINY, **(extra or {}))
    return params_to_numpy(tvit.init_params(torch.Generator().manual_seed(seed), cfg))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [{}, dict(reg_tokens=2, no_embed_class=True, distilled=True)],
                         ids=["classic", "registers-distilled"])
def test_layer_decay_factors_match_jax(extra):
    jp = _jp(extra)
    want = jax.tree.map(lambda p, f: np.full(np.shape(p), f, np.float32), jp,
                        jtrain.layer_decay_factors(jp, 0.75))
    got = ttrain.param_leaves(ttrain.layer_decay_factors(params_from_numpy(jp), 0.75))
    for w, g in zip(ttrain.param_leaves(params_from_numpy(want)), got):
        assert np.unique(w.numpy()).tolist() == [np.float32(g)]


def test_optimizer_chain_with_layer_decay_and_ema_matches_optax():
    """Clip, AdamW, layer decay and EMA inside MultiSteps: eight micro-steps
    (four updates) under ``grad_accum=2`` against ``build_optimizer``'s
    optax chain, the params and the EMA within 1e-6."""
    rng = np.random.default_rng(3)
    jp = _jp()
    kw = dict(lr_schedule="cosine", warmup_steps=2, grad_accum=2, grad_clip=1.0, ema=0.9,
              layer_decay=0.7)
    jtx = jtrain.build_optimizer(1e-2, 8, 0.05, params=jp, **kw)
    jparams = jax.tree.map(jnp.asarray, jp)
    st = jtx.init(jparams)
    update = jax.jit(jtx.update)
    tp = params_from_numpy(jp)
    ttx = ttrain.build_optimizer(1e-2, 8, 0.05, params=tp, **kw)
    tleaves = ttrain.param_leaves(tp)
    tst = ttx.init(tleaves)
    for _ in range(8):
        g = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), jp)
        upd, st = update(jax.tree.map(jnp.asarray, g), st, jparams)
        jparams = optax.apply_updates(jparams, upd)
        ttx.update(ttrain.param_leaves(params_from_numpy(g)), tst, tleaves)
    want = ttrain.param_leaves(params_from_numpy(jax.tree.map(np.asarray, jparams)))
    ema = ttrain.param_leaves(params_from_numpy(jax.tree.map(
        np.asarray, jtrain.get_ema_params(st, like=jparams))))
    got_ema = ttrain.param_leaves(ttrain.get_ema_params(tst, like=tp))
    for w, g, we, ge in zip(want, tleaves, ema, got_ema):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ge.numpy(), we.numpy(), rtol=0, atol=1e-6)
    assert tst.count == 4 and not torch.equal(got_ema[0], tleaves[0])


# ---------------------------------------------------------------------------
# Batch mixing and distillation
# ---------------------------------------------------------------------------


def test_cutmix_box_and_mixup_match_jax_draws():
    """CutMix's box and corrected λ from JAX's raw draws, and the apply half
    given JAX's λ and box, equal JAX's images and λ exactly."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((4, 16, 12, 3)).astype(np.float32)
    x = torch.from_numpy(images)
    for seed, step in ((0, 0), (1, 5), (2, 9)):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), jtrain._CUTMIX_TAG), step)
        mask, lam_c = jtrain.cutmix_mask_and_lam(k, 16, 12, 1.0)
        k_lam, k_cy, k_cx = jax.random.split(k, 3)
        raw = jax.random.beta(k_lam, 1.0, 1.0)
        cy, cx = int(jax.random.randint(k_cy, (), 0, 16)), int(jax.random.randint(k_cx, (), 0, 12))
        yl, yh, xl, xh, lam = ttrain.cutmix_box(np.float32(raw), cy, cx, 16, 12)
        box = np.zeros((16, 12), bool)
        box[yl:yh, xl:xh] = True
        np.testing.assert_array_equal(box, np.asarray(mask))
        assert lam == np.float32(lam_c)
        want, want_lam = jtrain.apply_batch_mix(jnp.asarray(images), seed, step, 0.0, 1.0)
        got, got_lam = ttrain.apply_batch_mix(x, {"mode": "cutmix", "lam": lam,
                                                  "box": (yl, yh, xl, xh)})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got_lam) == float(want_lam)
        lam_m = jtrain.mixup_lam(seed, step, 0.8)
        want, _ = jtrain.apply_batch_mix(jnp.asarray(images), seed, step, 0.8, 0.0)
        got, got_lam = ttrain.apply_batch_mix(x, {"mode": "mixup", "lam": np.float32(lam_m),
                                                  "box": None})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got_lam) == float(lam_m)


def test_mixing_draws_follow_the_key_schedule():
    a = ttrain.draw_batch_mix(3, 7, 32, 32, 0.8, 1.0, 0.5)
    assert a == ttrain.draw_batch_mix(3, 7, 32, 32, 0.8, 1.0, 0.5)
    modes = {ttrain.draw_batch_mix(3, s, 32, 32, 0.8, 1.0, 0.5)["mode"] for s in range(40)}
    assert modes == {"mixup", "cutmix"}
    assert ttrain.draw_batch_mix(3, 7, 32, 32, 0.0, 1.0)["mode"] == "cutmix"
    assert ttrain.draw_batch_mix(3, 7, 32, 32, 0.8, 0.0)["mode"] == "mixup"


@pytest.mark.parametrize("kind", ["mixed", "hard", "soft"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((6, 10))).astype(np.float32)
    teacher = (3 * rng.standard_normal((6, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    J, T = jnp.asarray, torch.from_numpy
    if kind == "mixed":
        want = jtrain.mixed_cross_entropy(J(logits), J(labels), jnp.float32(0.3), 0.1)
        got = ttrain.mixed_cross_entropy(T(logits), T(labels), torch.tensor(0.3), 0.1)
    else:
        want = jtrain.distillation_loss(J(logits), J(teacher), kind, 2.0)
        got = ttrain.distillation_loss(T(logits), T(teacher), kind, 2.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_synthetic_batch_is_numpys():
    """The CLI's synthetic batch is the JAX CLI's: ``default_rng(seed)``'s
    normals, then its labels, bit for bit, and the CLI trains on it."""
    rng = np.random.default_rng(11)
    want_x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    want_y = rng.integers(0, 5, 3).astype(np.int32)
    x, y = ttrain.synthetic_batch(11, 3, 32, 5)
    assert x.tobytes() == want_x.tobytes() and y.tobytes() == want_y.tobytes()
    seen = []
    sound = ttrain.make_train_step

    def spy(*a, **kw):
        step = sound(*a, **kw)
        return lambda state, im, lb: seen.append((im.clone(), lb.clone())) or step(state, im, lb)

    ttrain.make_train_step = spy
    try:
        ttrain.main(["--synthetic", "--model", MODEL, "--steps", "1", "--batch_size", "3",
                     "--seed", "11", "--device", "cpu", "--output", "/dev/null"])
    finally:
        ttrain.make_train_step = sound
    x, y = ttrain.synthetic_batch(11, 3, 32, 1000)
    assert seen[0][0].numpy().tobytes() == x.tobytes()
    assert seen[0][1].numpy().tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# Saving and resuming
# ---------------------------------------------------------------------------


def test_save_and_resume_is_bitwise(tmp_path):
    """Two steps, save, load into a fresh state, two more steps: the same
    params, EMA, moments and losses as four steps straight, with EMA, mixing,
    drop-path, layer decay and ``grad_accum`` on."""
    cfg = tvit.ViTConfig(**{**TINY, "depth": 3})
    sched = {"1": {"keep_ratio": 0.5}}
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1, 2, 3])

    def fresh(seed=0):
        params = tvit.init_params(torch.Generator().manual_seed(seed), cfg)
        tx = ttrain.build_optimizer(1e-3, 4, 0.05, grad_accum=2, ema=0.9, layer_decay=0.8,
                                    params=params)
        step = ttrain.make_train_step(cfg, sched, tx, 0.1, "cuda", 0.8, 1.0, 0.5, 7,
                                      drop_path=0.3)
        return ttrain.create_train_state(params, tx), step

    a, step_a = fresh()
    losses = [step_a(a, x, y)["loss"] for _ in range(4)]
    b, step_b = fresh()
    resumed = [step_b(b, x, y)["loss"] for _ in range(2)]
    ttrain.save_train_state(str(tmp_path / "s.state"), b)
    assert not (tmp_path / "s.state.tmp").exists()
    c, step_c = fresh(seed=99)
    c = ttrain.load_train_state(str(tmp_path / "s.state"), c)
    assert c.step == 2 and c.opt_state.count == 1 and c.opt_state.mini_step == 0
    resumed += [step_c(c, x, y)["loss"] for _ in range(2)]
    assert [float(v) for v in losses] == [float(v) for v in resumed]
    for name in ("mu", "nu", "ema"):
        assert all(torch.equal(p, q) for p, q in zip(getattr(a.opt_state, name),
                                                     getattr(c.opt_state, name)))
    assert all(torch.equal(p, q) for p, q in zip(ttrain.param_leaves(a.params),
                                                 ttrain.param_leaves(c.params)))
    with pytest.raises(ValueError, match="orbax"):
        ttrain.save_train_state(str(tmp_path / "o"), c, backend="orbax")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """12 solid-colour PNGs in 3 classes (colour 10·i for sample i in
    dataset order) and a saved random teacher."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    sizes = [(40, 30), (30, 44), (48, 48), (36, 50)]
    i = 0
    for c in range(3):
        (root / f"c{c}").mkdir()
        for j in range(4):
            h, w = sizes[j]
            Image.fromarray(np.full((h, w, 3), 10 * i, np.uint8)).save(root / f"c{c}" / f"{j}.png")
            i += 1
    teacher = root.parent / "teacher.msgpack"
    cfg = tvit.get_config(MODEL)
    save_params(str(teacher), tvit.init_params(torch.Generator().manual_seed(5), cfg))
    sched = root.parent / "sched.json"
    sched.write_text(json.dumps({"3": {"keep_ratio": 0.5}, "6": {"keep_ratio": 0.5}}))
    return root, teacher, sched


def _recipe(folder, out, steps) -> list:
    root, teacher, sched = folder
    return ["--data_path", str(root), "--model", MODEL, "--schedule", str(sched),
            "--steps", str(steps), "--batch_size", "4", "--device", "cpu", "--kernels", "cuda",
            "--augment", "--canvas", "64", "--rand_augment", "rand-m9-mstd0.5-inc1",
            "--reprob", "0.25", "--mixup", "0.8", "--cutmix", "1.0", "--drop_path", "0.1",
            "--layer_decay", "0.75", "--ema", "0.9999", "--remat", "--distill_teacher",
            str(teacher), "--distill_model", MODEL, "--eval_data", str(root), "--eval_every", "1",
            "--eval_batches", "1", "--shuffle", "--save_state_every", "1", "--log_every", "1",
            "--output", str(out)]


def test_cli_recipe_on_an_image_folder_resumes_bitwise(folder, tmp_path, capsys):
    """The recipe's flags on an image folder: two steps straight, and one
    step, then ``--resume`` for the second (the loader fast-forwarding), end
    on the same params and EMA, bit for bit."""
    straight = ttrain.main(_recipe(folder, tmp_path / "a.msgpack", 2))
    ttrain.main(_recipe(folder, tmp_path / "b.msgpack", 1))
    resumed = ttrain.main(_recipe(folder, tmp_path / "b.msgpack", 2)
                          + ["--resume", str(tmp_path / "b.msgpack.state")])
    out = capsys.readouterr().out
    assert "route: cuda" in out and "val_top1 (ema)" in out and "distilling from" in out
    assert "resume: fast-forwarding the data stream 1 batches" in out
    assert resumed.step == straight.step == 2
    for p, q in zip(ttrain.param_leaves(straight.params), ttrain.param_leaves(resumed.params)):
        assert torch.equal(p, q)
    assert all(torch.equal(p, q) for p, q in zip(straight.opt_state.ema, resumed.opt_state.ema))
    saved = [ttrain.param_leaves(load_params(str(tmp_path / f"{r}.msgpack.ema"))) for r in "ab"]
    assert all(torch.equal(p, q) for p, q in zip(*saved))


def test_shuffle_order_and_fast_forward(folder):
    """``--shuffle`` reads each pass in ``default_rng([seed, pass])``'s
    permutation of the dataset, full batches only; a stream started at step
    s yields what the uninterrupted stream yields after s batches."""
    from rajni_tpu_torch.data.pipeline import ImageFolder

    root = folder[0]
    args = argparse.Namespace(data_path=str(root), augment=True, canvas=64, repeated_aug=0,
                              batch_size=5, shuffle=True, seed=3)
    cfg = tvit.get_config(MODEL)
    colour = {path: 10 * i for i, (path, _) in enumerate(ImageFolder(str(root)).samples)}
    base = list(colour.values())
    want = []
    for pas in range(3):
        order = [base[j] for j in np.random.default_rng([3, pas]).permutation(12)]
        want += [order[k:k + 5] for k in (0, 5)]  # two full batches a pass, 2 left over
    stream = ttrain._train_batches(args, cfg, 0)
    got = [next(stream)[0][0][:, 0, 0, 0].tolist() for _ in range(6)]
    assert got == want
    late = ttrain._train_batches(args, cfg, 3)
    assert [next(late)[0][0][:, 0, 0, 0].tolist() for _ in range(3)] == want[3:]


@pytest.mark.parametrize("bad, match", [
    (["--eval_every", "2"], "--eval_every requires --eval_data"),
    (["--drop_path", "1.0"], r"--drop_path must be in \[0, 1\)"),
    (["--distill_teacher", "t.msgpack"], "requires --distill_model"),
    (["--augment"], "--augment requires a real --data_path"),
    (["--reprob", "0.25"], "require --augment"),
    (["--repeated_aug", "1"], "must be 0 \\(off\\) or >= 2"),
    (["--data_path", "d", "--augment", "--rand_augment", "rand-x3"],
     "unsupported RandAugment token"),
    (["--ema", "1.0"], "--ema decay must be in"),
    (["--state_backend", "orbax"], "orbax is not ported"),
], ids=["eval_every", "drop_path", "distill", "augment", "reprob", "repeated_aug",
        "rand_augment", "ema", "orbax"])
def test_cli_checks_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        ttrain.get_args(bad if "--data_path" in bad else ["--synthetic", *bad])


def test_cli_needs_a_data_source_and_a_big_enough_folder(folder):
    with pytest.raises(ValueError, match="provide --data_path or --synthetic"):
        ttrain.get_args([])
    with pytest.raises(ValueError, match="smaller than the batch"):
        ttrain.main(["--data_path", str(folder[0]), "--model", MODEL, "--batch_size", "13",
                     "--device", "cpu", "--steps", "1", "--output", "/dev/null"])
