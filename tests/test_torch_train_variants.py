"""The extended timm variants in training, against the JAX package. DeiT-3's
patch-only pos-embed with a pooled head (``global_pool="avg"``,
``fc_norm``) trains on the kernel route (the kernels' plain versions here),
held to JAX's ``vit_forward_train``; registers, the distillation token (its
two heads, ``return_dist``) and qk-norm are demoted to the plain forward,
held under drop-path with JAX's masks to ``vit_forward(impl="xla",
drop_path, rng)`` under ``jax.grad``. Each feature combination runs in one
config so that JAX compiles each route once.

The narrow config is tests/test_torch_train.py's (C=128, 2 heads, 64 px,
depth 6, batch 2). Tolerances: the loss within 1e-5 and the worst relative
gradient within 1e-4 against JAX's kernel path, as that file holds them;
1e-3 against the XLA route for the demoted configs (JAX's own bound between
its kernel and XLA paths), though they run the same math and read closer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.models import train_path as jtp
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch import train as ttrain
from rajni_tpu_torch.models import train_path as ttp
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params.from_jax import params_to_numpy
from rajni_tpu_torch.params.io import save_params

BASE = dict(img_size=64, patch_size=16, embed_dim=128, depth=6, num_heads=2, num_classes=10,
            use_layer_scale=True)
ON_KERNELS = dict(no_embed_class=True, global_pool="avg", use_fc_norm=True)  # DeiT-3, pooled
DEMOTED = dict(reg_tokens=2, no_embed_class=True, distilled=True, qk_norm=True)
SCHED = {"3": {"keep_ratio": 0.7, "update": True},
         "4": {"keep_ratio": 0.7, "update": False},
         "5": {"keep_ratio": 0.6, "update": True}}
LABELS = np.array([3, 7])
RATE = 0.6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(extra: dict, seed: int):
    """JAX-layout numpy params of the variant (made by the port's init and
    carried back), with non-trivial biases, norms and tokens; images."""
    rng = np.random.default_rng(seed)
    tcfg = tvit.ViTConfig(**BASE, **extra)
    jp = params_to_numpy(tvit.init_params(torch.Generator().manual_seed(seed), tcfg))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    for blk in jp["blocks"]:
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * f(*d["bias"].shape)
        blk["ls1"], blk["ls2"] = 0.5 * f(128), 0.5 * f(128)
        for name in ("q_norm", "k_norm"):
            if name in blk["attn"]:
                blk["attn"][name]["scale"] = 1 + 0.2 * f(64)
    for name in ("cls_token", "dist_token", "reg_token"):
        if name in jp:
            jp[name] = 0.1 * f(*jp[name].shape)
    return jvit.ViTConfig(**BASE, **extra), tcfg, jp, f(2, 64, 64, 3)


def _rel(want, got) -> float:
    """``max |want − got| / max |want|``; absolute where ``want`` is zero up
    to rounding (below 1e-6: the k-norm bias, whose gradient the softmax's
    shift invariance cancels, reads ~1e-8 on both sides)."""
    want = torch.as_tensor(np.array(want))
    diff, scale = float((want - got).abs().max()), float(want.abs().max())
    return diff / scale if scale > 1e-6 else diff


def _loss_jax(lg):
    lg = lg.astype(jnp.float32)
    return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]), LABELS])


def _jax_grads(f, jp):
    loss, g = jax.jit(jax.value_and_grad(f))(jax.tree.map(jnp.asarray, jp))
    return float(loss), ttrain.param_leaves(params_from_numpy(jax.tree.map(np.asarray, g)))


def _port_grads(f, jp):
    params = params_from_numpy(jp)
    leaves = ttrain.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = f(params)
    return loss.item(), torch.autograd.grad(loss, leaves)


def test_deit3_pooled_head_trains_on_the_kernels():
    """DeiT-3's patch-only pos-embed and the pooled fc_norm head keep the
    kernel route (on the card too) and match JAX's kernel path."""
    jcfg, tcfg, jp, images = _setup(ON_KERNELS, 0)
    assert tvit.resolve_route("cuda", tcfg, torch.bfloat16, "cuda", training=True) == ("cuda", "")
    calls = []
    sound = ttp._StockBlock.apply
    ttp._StockBlock.apply = lambda *a: calls.append(1) or sound(*a)
    try:
        x = torch.from_numpy(images)
        loss, grads = _port_grads(lambda p: ttrain.cross_entropy(
            ttp.vit_forward_train(p, x, tcfg, SCHED), torch.from_numpy(LABELS)), jp)
    finally:
        ttp._StockBlock.apply = sound
    assert len(calls) == 3  # the block ops ran, not the plain forward
    xj = jnp.asarray(images)
    l_k, g_k = _jax_grads(lambda p: _loss_jax(jtp.vit_forward_train(
        p, xj, jcfg, jvit.normalize_schedule(SCHED, 6), stock_impl="pallas")), jp)
    assert abs(loss - l_k) < 1e-5
    assert max(_rel(a, b) for a, b in zip(g_k, grads)) < 1e-4


def test_demoted_variants_match_jax_xla_with_drop_path():
    """Registers, a distillation token and qk-norm: the kernel route demotes
    to the plain forward (on every device), whose two heads (``return_dist``)
    and drop-path with JAX's masks match JAX's ``vit_forward(impl="xla")``."""
    jcfg, tcfg, jp, images = _setup(DEMOTED, 1)
    assert tvit.resolve_route("cuda", tcfg, torch.bfloat16, "cpu", training=True)[0] == "torch"
    rng = jax.random.key(3)
    jm = []
    for i, r in enumerate(jvit.drop_path_rates(RATE, 6)):
        k = jax.random.split(jax.random.fold_in(rng, i))
        jm.append(None if r == 0.0 else tuple(jtp._dp_mask(k[j], r, 2, jnp.float32)
                                              for j in range(2)))
    masks = [None if m is None else tuple(torch.from_numpy(np.array(a)) for a in m) for m in jm]
    xj = jnp.asarray(images)

    def jloss(p):
        cls, dist = jvit.vit_forward(p, xj, jcfg, jvit.normalize_schedule(SCHED, 6), "xla",
                                     drop_path=RATE, rng=rng, return_dist=True)
        return _loss_jax(cls) + 0.5 * _loss_jax(dist)

    def tloss(p):
        cls, dist = ttp.vit_forward_train(p, torch.from_numpy(images), tcfg, SCHED,
                                          dp_masks=masks, return_dist=True)
        labels = torch.from_numpy(LABELS)
        return ttrain.cross_entropy(cls, labels) + 0.5 * ttrain.cross_entropy(dist, labels)

    l_x, g_x = _jax_grads(jloss, jp)
    loss, grads = _port_grads(tloss, jp)
    assert abs(loss - l_x) < 1e-3
    assert max(_rel(a, b) for a, b in zip(g_x, grads)) < 1e-3


@pytest.mark.parametrize("extra", [dict(reg_tokens=4, no_embed_class=True),
                                   dict(distilled=True), dict(qk_norm=True)],
                         ids=["registers", "distilled", "qk-norm"])
def test_demoted_route_line_says_why(extra):
    cfg = dataclasses.replace(tvit.get_config("vit_base_patch16_224"), **extra)
    impl, why = tvit.resolve_route("cuda", cfg, torch.bfloat16, "cuda", training=True)
    line = tvit.route_line(impl, why)  # the line the train CLI prints
    assert impl == "torch" and line.startswith("route: torch (an extended timm variant: ")
    assert line.endswith("the kernels take one prefix token and no qk-norm)")
    word = {"reg_tokens": "4 register tokens", "distilled": "a distillation token",
            "qk_norm": "qk-norm"}[next(k for k in extra if k != "no_embed_class")]
    assert word in line


def test_distilled_student_keeps_its_teacher_on_the_kernels(tmp_path, capsys):
    """The train CLI resolves the teacher's route from the teacher's own
    config: a distilled student is demoted to the plain forward, and its
    plain-ViT teacher still runs the kernel route (``--kernels cuda``; on the
    CPU the kernels' plain versions)."""
    teacher = tmp_path / "teacher.msgpack"
    save_params(str(teacher), tvit.init_params(torch.Generator().manual_seed(5),
                                               tvit.get_config("deit_tiny_patch16_32")))
    seen = []
    sound = ttrain.vit_forward

    def spy(params, images, config, schedule=None, impl="torch", *a, **kw):
        if not torch.is_grad_enabled():
            seen.append((config.distilled, impl))
        return sound(params, images, config, schedule, impl, *a, **kw)

    ttrain.vit_forward = spy
    try:
        ttrain.main(["--synthetic", "--model", "deit_tiny_distilled_patch16_32", "--steps", "1",
                     "--batch_size", "2", "--device", "cpu", "--kernels", "cuda",
                     "--distill_teacher", str(teacher), "--distill_model",
                     "deit_tiny_patch16_32", "--output", str(tmp_path / "s.msgpack")])
    finally:
        ttrain.vit_forward = sound
    out = capsys.readouterr().out.splitlines()
    assert ("route: torch (an extended timm variant: a distillation token; the kernels take "
            "one prefix token and no qk-norm)") in out
    assert "teacher route: cuda" in out
    assert seen == [(False, "cuda")]


def test_single_head_return_dist_aliases_the_head():
    """JAX's "usual distillation": a model without a distillation head
    returns its one head's logits twice."""
    cfg = tvit.ViTConfig(**BASE)
    params = tvit.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    cls, dist = ttp.vit_forward_train(params, x, cfg, SCHED, return_dist=True)
    assert torch.equal(cls, dist)
    assert torch.equal(cls, ttp.vit_forward_train(params, x, cfg, SCHED))
