"""The extended timm variants on the port (``rajni_tpu_torch/models/vit.py``)
against the JAX package's, on the CPU.

Six variants of a narrow ViT (C = 48, 4 heads, 3 blocks, 16 patches):
four register tokens with a patch-only pos-embed and LayerScale (DINOv2's
``_reg4``), DeiT's distillation token and second head, qk-norm, the ``avg``
head with ``fc_norm`` (MAE's) and without it, and DeiT-3's patch-only
pos-embed with LayerScale. For each, the same JAX-initialized params (every
leaf made non-trivial) and the same numpy images go through the port's
``impl="torch"`` forward and JAX's ``impl="xla"``, pruned (with a block that
reuses the threaded scores) and identity, in fp32: logits at rtol 1e-4 /
atol 1e-5, selections exact. The variants that keep one prefix token and no
qk-norm also run the port's ``impl="cuda"`` route, which on CPU tensors runs
the kernels' plain versions, against the same JAX forward. Then
``model_stats``, ``adapt_config_to_params``, a timm-layout state dict
(tests/test_params.py's ``TorchOracleViT``) through ``convert_timm_state_dict``
→ ``params_from_numpy`` → the forward, and the route each variant takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.models import vit as jvit
from rajni_tpu.params import convert as jconvert
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params import convert as tconvert
from rajni_tpu_torch.params.from_jax import params_to_numpy
from tests.test_params import CFG as ORACLE_CFG, TorchOracleViT

ACT = dict(rtol=1e-4, atol=1e-5)
BASE = dict(img_size=32, patch_size=8, embed_dim=48, depth=3, num_heads=4, num_classes=10)
SCHED = {1: {"keep_ratio": 0.6, "update": True}, 2: {"keep_ratio": 0.5, "update": False}}
VARIANTS = {
    "reg4": dict(reg_tokens=4, no_embed_class=True, use_layer_scale=True),
    "distilled": dict(distilled=True),
    "qk_norm": dict(qk_norm=True),
    "avg_fc_norm": dict(global_pool="avg"),
    "avg_no_fc_norm": dict(global_pool="avg", use_fc_norm=False),
    "deit3": dict(no_embed_class=True, use_layer_scale=True),
}
# one prefix token and no qk-norm: the kernels take these (JAX's rule)
KERNEL_VARIANTS = ("avg_fc_norm", "avg_no_fc_norm", "deit3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, rng):
    """Every leaf of a JAX numpy tree made non-trivial: norms' scales near
    1, biases, tokens and layer scales drawn, so that each one is carried."""
    if isinstance(tree, list):
        return [_perturbed(v, rng) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _perturbed(v, rng)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("bias", "cls_token", "dist_token", "reg_token"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("ls1", "ls2"):
            out[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _jax_forward(params, images, cfg, schedule):
    """JAX's ``impl="xla"`` forward under one ``jax.jit`` (eager dispatch
    compiles op by op, ~8x slower here): ``(logits, {block: keep_idx})``."""
    sched = jvit.normalize_schedule(schedule, cfg.depth)

    def fwd(p, x):
        sels = {}
        out = jvit.vit_forward(p, x, cfg, sched, "xla",
                               _sel_tap=lambda i, k: sels.__setitem__(i, k))
        return out, sels

    out, sels = jax.jit(fwd)(jax.tree.map(jnp.asarray, params), jnp.asarray(images))
    return np.asarray(out), {i: np.asarray(k) for i, k in sels.items()}


def _setup(variant: str, rng):
    jcfg = jvit.ViTConfig(**BASE, **VARIANTS[variant])
    tcfg = tvit.ViTConfig(**BASE, **VARIANTS[variant])
    jp = _perturbed(jax.tree.map(np.asarray, jvit.init_params(jax.random.key(1), jcfg)), rng)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    return jcfg, tcfg, jp, images


@pytest.mark.parametrize("schedule", [None, SCHED], ids=["identity", "pruned"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_forward_matches_jax(rng, variant, schedule):
    jcfg, tcfg, jp, images = _setup(variant, rng)
    tp = params_from_numpy(jp)
    want, jsel = _jax_forward(jp, images, jcfg, schedule)
    tsel = {}
    x = torch.from_numpy(images)
    got = tvit.vit_forward(tp, x, tcfg, schedule, "torch",
                           _sel_tap=lambda i, k: tsel.__setitem__(i, k.numpy()))
    np.testing.assert_allclose(got.numpy(), want, **ACT)
    assert sorted(jsel) == sorted(tsel) == ([1, 2] if schedule else [])
    for i in jsel:
        np.testing.assert_array_equal(tsel[i], jsel[i])
        assert tsel[i].shape[1] == tvit.keep_count(
            SCHED[i]["keep_ratio"], tcfg.num_tokens if i == 1 else tsel[1].shape[1],
            tcfg.num_prefix_tokens) + tcfg.num_prefix_tokens
        np.testing.assert_array_equal(tsel[i][:, :tcfg.num_prefix_tokens],
                                      np.arange(tcfg.num_prefix_tokens)[None].repeat(3, 0))
    if variant in KERNEL_VARIANTS:  # the kernels' plain versions, on CPU tensors
        cuda_sel = {}
        got_cuda = tvit.vit_forward(tp, x, tcfg, schedule, "cuda",
                                    _sel_tap=lambda i, k: cuda_sel.__setitem__(i, k.numpy()))
        np.testing.assert_allclose(got_cuda.numpy(), want, **ACT)
        for i in jsel:
            np.testing.assert_array_equal(cuda_sel[i], jsel[i])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_stats_adapt_and_tree_round_trip(rng, variant):
    jcfg, tcfg, jp, _ = _setup(variant, rng)
    for schedule in (None, SCHED, {0: {"keep_ratio": 0.3}}):
        assert (tvit.model_stats(tcfg, schedule)
                == jvit.model_stats(jcfg, jvit.normalize_schedule(schedule, jcfg.depth)))
    base_t, base_j = tvit.ViTConfig(**BASE), jvit.ViTConfig(**BASE)
    tp = params_from_numpy(jp)
    adapted = tvit.adapt_config_to_params(base_t, tp)
    want = jvit.adapt_config_to_params(base_j, jax.tree.map(jnp.asarray, jp))
    assert dataclasses.asdict(adapted) == dataclasses.asdict(want)
    assert adapted.num_prefix_tokens == tcfg.num_prefix_tokens
    assert adapted.fc_norm_resolved == tcfg.fc_norm_resolved
    # the port's own init carries the same leaves as JAX's
    own = tvit.init_params(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(params_to_numpy(own)) == jax.tree.structure(jp)
    # and the tree round-trips the JAX layout leaf for leaf
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def _oracle_variant(variant: str):
    """A timm-layout oracle with the variant's flags (tests/test_params.py)."""
    kw = dict(VARIANTS[variant])
    layer_scale = kw.pop("use_layer_scale", False)
    torch.manual_seed(11)
    jcfg = dataclasses.replace(ORACLE_CFG, use_layer_scale=layer_scale, **kw)
    return jcfg, TorchOracleViT(jcfg, layer_scale=layer_scale).eval()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_timm_state_dict_converts_and_runs(rng, variant):
    """The flags read from the state dict's keys are JAX's; the tree the
    variant's config converts runs as JAX's and as the oracle. (``avg``
    without ``fc_norm`` leaves no key behind: its config declares it.)"""
    jcfg, oracle = _oracle_variant(variant)
    sd = oracle.state_dict()

    def port_cfg(c):
        return tvit.ViTConfig(**{f.name: getattr(c, f.name)
                                 for f in dataclasses.fields(tvit.ViTConfig)})

    base = port_cfg(ORACLE_CFG)
    adapted = tconvert.adapt_config(base, sd)
    assert dataclasses.asdict(adapted) == dataclasses.asdict(jconvert.adapt_config(ORACLE_CFG, sd))
    tcfg = port_cfg(jcfg)
    def semantics(c):  # what the forward reads (LayerScale comes with its gammas)
        return (c.reg_tokens, c.distilled, c.no_embed_class, c.qk_norm, c.global_pool,
                c.fc_norm_resolved)

    assert (semantics(adapted) == semantics(tcfg)) == (variant != "avg_no_fc_norm")
    params = params_from_numpy(tconvert.convert_timm_state_dict(sd, tcfg))
    assert tvit.adapt_config_to_params(base, params) == adapted
    jparams = jconvert.convert_timm_state_dict(sd, jcfg)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        oracle_logits = oracle(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
        for schedule in (None, {1: {"keep_ratio": 0.5}}):
            got = tvit.vit_forward(params, torch.from_numpy(images), tcfg, schedule, "torch")
            want, _ = _jax_forward(jparams, images, jcfg, schedule)
            np.testing.assert_allclose(got.numpy(), want, **ACT)
            if schedule is None:
                np.testing.assert_allclose(got.numpy(), oracle_logits, **ACT)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_routes(variant):
    cfg = dataclasses.replace(tvit.get_config("vit_base_patch16_224"), **VARIANTS[variant])
    jcfg = dataclasses.replace(jvit.get_config("vit_base_patch16_224"), **VARIANTS[variant])
    assert cfg.kernel_path_supported == jcfg.kernel_path_supported
    on_kernels = variant in KERNEL_VARIANTS
    assert cfg.kernel_path_supported == on_kernels
    why = "" if on_kernels else tvit.variant_reason(cfg)
    assert on_kernels or why.startswith("an extended timm variant: ")
    want = ("cuda", "") if on_kernels else ("torch", why)
    assert tvit.resolve_route("cuda", cfg, torch.bfloat16, "cuda") == want
    assert tvit.resolve_route("auto", cfg, torch.bfloat16, "cuda") == want
    assert tvit.cuda_kernels_take(cfg, torch.bfloat16) == (on_kernels, want[1])
    # an extended variant leaves the kernel route on the CPU too (JAX demotes
    # "pallas" on every backend); the CPU's "auto" is "torch"
    assert tvit.resolve_route("cuda", cfg, torch.float32, "cpu")[0] == want[0]
    assert tvit.resolve_route("auto", cfg, torch.float32, "cpu") == ("torch", "")
    # int8 weights: ViT-B's widths take the int8 kernels where the variant does
    assert tvit.resolve_route("cuda", cfg, torch.bfloat16, "cuda", quantized=True) == want
    line = tvit.route_line(*want)
    assert line == ("route: cuda" if on_kernels else f"route: torch ({why})")


def test_qk_norm_block_refuses_cuda_impl(rng):
    """The ops refuse ``impl="cuda"`` on a qk-normed block (B6 and the
    dense selection take no per-head norms) instead of running the plain
    version; ``impl="torch"`` runs it."""
    from rajni_tpu_torch.ops import attention as tattn

    _, tcfg, jp, _ = _setup("qk_norm", rng)
    attn = params_from_numpy(jp)["blocks"][0]["attn"]
    H, C = tcfg.num_heads, tcfg.embed_dim
    x = torch.from_numpy(rng.standard_normal((2, 17, C)).astype(np.float32))
    scale = (C // H) ** -0.5
    with pytest.raises(ValueError, match="qk-normed block"):
        tattn.attention(x, attn, H, scale, impl="cuda")
    with pytest.raises(ValueError, match="qk-normed block"):
        tattn.pruned_attention(x, attn, H, scale, 8, True, None, impl="cuda")
    assert tattn.attention(x, attn, H, scale, impl="torch").shape == (2, 17, C)
    out, idx, _ = tattn.pruned_attention(x, attn, H, scale, 8, True, None, impl="torch")
    assert out.shape == (2, 9, C) and idx.shape == (2, 9)
