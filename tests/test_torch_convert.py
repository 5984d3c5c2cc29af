"""The port's timm checkpoint conversion (``rajni_tpu_torch/params/convert.py``
and ``params/io.py:load_checkpoint_auto``) against the JAX package's, on the
CPU.

A ``TorchOracleViT`` (tests/test_params.py: timm's layout and semantics)
state_dict goes through both converters: the numpy trees are equal bit for
bit, plain and with LayerScale, from the state_dict and from ``.pth`` files
in timm's wrappings (``{"model": ...}``, ``{"state_dict": ...}``, a
``module.`` prefix). The pos-embed resample (197 → 577 tokens) and the
variant flags are JAX's exactly; the extended variants convert, and
``params_from_numpy`` carries their leaves, from which
``adapt_config_to_params`` reads the same flags. The converted
forward in fp32 matches JAX's forward on JAX's converted params and the
oracle's logits at rtol 1e-4 / atol 1e-5 (tests/test_torch_forward.py's
tolerance), and the convert CLI's msgpack loads in both packages.
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
from rajni_tpu.params import io as jio
from rajni_tpu.utils.schedule import normalize_schedule
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params import convert as tconvert
from rajni_tpu_torch.params import io as tio
from rajni_tpu_torch.params.from_jax import params_to_numpy
from tests.test_params import CFG, TorchOracleViT

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg) -> tvit.ViTConfig:
    """The port's config of the same fields."""
    names = {f.name for f in dataclasses.fields(tvit.ViTConfig)}
    return tvit.ViTConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def _oracle(seed=0, layer_scale=False, **kw):
    torch.manual_seed(seed)
    jcfg = dataclasses.replace(CFG, use_layer_scale=layer_scale, **kw)
    return jcfg, TorchOracleViT(jcfg, layer_scale=layer_scale).eval()


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layer_scale", [False, True], ids=["plain", "layer_scale"])
def test_convert_bitwise_equal_to_jax(layer_scale):
    jcfg, oracle = _oracle(layer_scale=layer_scale)
    sd = oracle.state_dict()
    got = tconvert.convert_timm_state_dict(sd, _tcfg(jcfg))
    _assert_trees_equal(got, jconvert.convert_timm_state_dict(sd, jcfg))
    assert ("ls1" in got["blocks"][0]) == layer_scale


@pytest.mark.parametrize("wrap", ["raw", "model", "state_dict", "module. in model"])
def test_pth_files_load_and_convert_as_jax(tmp_path, wrap):
    jcfg, oracle = _oracle(seed=1)
    sd = oracle.state_dict()
    obj = {"raw": sd, "model": {"model": sd, "epoch": 3}, "state_dict": {"state_dict": sd},
           "module. in model": {"model": {f"module.{k}": v for k, v in sd.items()}}}[wrap]
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    got, want = tconvert.load_torch_checkpoint(path), jconvert.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    _assert_trees_equal(tconvert.convert_timm_state_dict(got, _tcfg(jcfg)),
                        jconvert.convert_timm_state_dict(want, jcfg))


def test_bf16_state_dict_converts_exactly():
    jcfg, oracle = _oracle(seed=2)
    sd = {k: v.to(torch.bfloat16) for k, v in oracle.state_dict().items()}
    _assert_trees_equal(tconvert.convert_timm_state_dict(sd, _tcfg(jcfg)),
                        jconvert.convert_timm_state_dict(sd, jcfg))


def test_resample_pos_embed_bitwise_jax_197_to_577():
    pe = np.random.default_rng(3).standard_normal((1, 197, 16)).astype(np.float32)
    got = tconvert.resample_pos_embed(pe, 577)
    np.testing.assert_array_equal(got, jconvert.resample_pos_embed(pe, 577))
    assert got.shape == (1, 577, 16)
    np.testing.assert_array_equal(got[:, 0], pe[:, 0])
    # timm's resampler: F.interpolate(bicubic, antialias=True) of the 14x14 grid
    grid = torch.from_numpy(pe[:, 1:]).reshape(1, 14, 14, 16).permute(0, 3, 1, 2)
    ref = torch.nn.functional.interpolate(grid, size=(24, 24), mode="bicubic",
                                          align_corners=False, antialias=True)
    np.testing.assert_allclose(got[0, 1:], ref.permute(0, 2, 3, 1).reshape(576, 16).numpy(),
                               rtol=0, atol=1e-5)
    for n_in, n_out in ((14, 24), (24, 14), (7, 7)):
        np.testing.assert_array_equal(tconvert._cubic_weights(n_in, n_out),
                                      jconvert._cubic_weights(n_in, n_out))


VARIANTS = {
    "plain": {},
    "qk_norm": dict(qk_norm=True),
    "registers": dict(reg_tokens=3, no_embed_class=True),
    "avg_pool": dict(global_pool="avg"),
    "distilled": dict(distilled=True),
    "dinov2": dict(reg_tokens=2, no_embed_class=True, qk_norm=True, global_pool="avg"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_adapt_config_and_variants_as_jax(variant):
    jcfg, oracle = _oracle(seed=4, **VARIANTS[variant])
    sd = oracle.state_dict()
    got = tconvert.adapt_config(_tcfg(CFG), sd)
    want = jconvert.adapt_config(CFG, sd)
    assert got == _tcfg(want)
    tree = tconvert.convert_timm_state_dict(sd, got)
    _assert_trees_equal(tree, jconvert.convert_timm_state_dict(sd, want))
    if variant == "plain":
        assert got == _tcfg(CFG)
        params_from_numpy(tree)
        return
    with pytest.raises(ValueError, match="adapt_config|qk_norm|fc_norm|reg|distil"):
        tconvert.convert_timm_state_dict(sd, _tcfg(CFG))
    # the variant's leaves come through, and name the same flags again
    params = params_from_numpy(tree)
    assert tvit.adapt_config_to_params(_tcfg(CFG), params) == got


@pytest.mark.parametrize("layer_scale", [False, True], ids=["plain", "layer_scale"])
def test_converted_logits_match_jax_and_the_oracle(rng, layer_scale):
    jcfg, oracle = _oracle(seed=5, layer_scale=layer_scale)
    sd = oracle.state_dict()
    tcfg = _tcfg(jcfg)
    params = params_from_numpy(tconvert.convert_timm_state_dict(sd, tcfg))
    jparams = jconvert.convert_timm_state_dict(sd, jcfg)
    images = rng.standard_normal((3, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    jforward = jax.jit(jvit.vit_forward, static_argnums=(2, 3, 4))
    with torch.no_grad():
        oracle_logits = oracle(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
        for sched in (None, {1: {"keep_ratio": 0.5}}):
            got = tvit.vit_forward(params, torch.from_numpy(images), tcfg, sched, "torch")
            want = jforward(jparams, jnp.asarray(images), jcfg,
                            normalize_schedule(sched, jcfg.depth), "xla")
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            if sched is None:
                np.testing.assert_allclose(got.numpy(), oracle_logits, **TOL)


def test_convert_cli_msgpack_loads_in_both_packages(tmp_path, capsys):
    """The CLI at a timm model name (random weights in timm's layout), and
    ``load_checkpoint_auto`` on the ``.pth``, at its grid and at a larger
    one (the pos-embed resampled, 17 → 37 tokens)."""
    gen = torch.Generator().manual_seed(6)
    name = "vit_tiny_patch16_64"
    cfg = tvit.get_config(name)
    C, hidden = cfg.embed_dim, cfg.mlp_hidden
    sd = {"cls_token": torch.randn(1, 1, C, generator=gen),
          "pos_embed": torch.randn(1, cfg.num_tokens, C, generator=gen),
          "patch_embed.proj.weight": torch.randn(C, 3, 16, 16, generator=gen),
          "patch_embed.proj.bias": torch.randn(C, generator=gen),
          "norm.weight": torch.randn(C, generator=gen), "norm.bias": torch.zeros(C),
          "head.weight": torch.randn(1000, C, generator=gen), "head.bias": torch.zeros(1000)}
    for i in range(cfg.depth):
        for leaf, shape in (("norm1", (C,)), ("norm2", (C,)), ("attn.qkv", (3 * C, C)),
                            ("attn.proj", (C, C)), ("mlp.fc1", (hidden, C)),
                            ("mlp.fc2", (C, hidden))):
            sd[f"blocks.{i}.{leaf}.weight"] = torch.randn(*shape, generator=gen)
            sd[f"blocks.{i}.{leaf}.bias"] = torch.randn(shape[0], generator=gen)
    src, out = str(tmp_path / "vit.pth"), str(tmp_path / "vit.msgpack")
    torch.save({"model": sd}, src)
    tconvert.main([src, out, "--model", name])
    assert f"converted {name}: 5.7M params -> {out}" in capsys.readouterr().out
    tree = tconvert.convert_timm_state_dict(tconvert.load_torch_checkpoint(src), cfg)
    _assert_trees_equal(jax.tree.map(np.asarray, jio.load_params(out)), tree)
    _assert_trees_equal(params_to_numpy(tio.load_params(out)), tree)
    _assert_trees_equal(params_to_numpy(tio.load_checkpoint_auto(src, name)), tree)
    at96 = tio.load_checkpoint_auto(src, "vit_tiny_patch16_96", dtype=torch.bfloat16)
    want = jio.load_checkpoint_auto(src, "vit_tiny_patch16_96")
    assert at96["pos_embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(at96["pos_embed"].float().numpy(),
                                  np.asarray(want["pos_embed"].astype(jnp.bfloat16),
                                             np.float32))
