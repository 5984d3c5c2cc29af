"""The port at head_dim 80 (ViT-H/14's heads) against the JAX package.

A narrow ViT-H-shaped config: C = 160, 2 heads (head_dim 80), hidden 640, 56
px images in 14 px patches (17 tokens), depth 4, keep 0.7 at blocks 1 and 2.
The same numpy-made params and images go through both packages in fp32 on
the CPU: ``impl="torch"`` against JAX ``"xla"``, ``impl="cuda"`` (the kernels'
plain versions on CPU tensors) against JAX ``"pallas"`` in interpret mode.
Then B6, the gathered attention, the RAJNI scores, K3 and the LayerNorm at
ViT-H's head_dim 80 and C = 1280 on their own, and the card's route gate
(tests/test_torch_int8_vit_h.py holds the int8 kernels at these widths).
Tolerances as tests/test_torch_forward.py: rtol 1e-4 / atol 1e-5 on
activations and logits; selections and token counts exactly. In bf16, where
the blocks' SDPA forms differ (q·scale rounded first, or the scale on the
fp32 logits: 2.7e-3 rel L2 apart at 80^-0.5), the blocks' ``_mha`` and the
kernels' plain versions are held to JAX's ``_mha`` at 3e-4 rel L2
(``chip_smoke.py``'s B6_REL_L2 gate, rounded up).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.kernels import attention as jattn
from rajni_tpu.kernels import block as jblock
from rajni_tpu.kernels import mlp as jmlp
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch.kernels import attention as tattn
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import mlp as tmlp
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.quant import quantize_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ACT = dict(rtol=1e-4, atol=1e-5)
CFG = dict(img_size=56, patch_size=14, embed_dim=160, depth=4, num_heads=2, num_classes=10)
SCHED = {1: {"keep_ratio": 0.7}, 2: {"keep_ratio": 0.7}}
SCALE = 80 ** -0.5


def _setup(rng, layer_scale: bool):
    jcfg = jvit.ViTConfig(**CFG, use_layer_scale=layer_scale)
    tcfg = tvit.ViTConfig(**CFG, use_layer_scale=layer_scale)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0), jcfg))
    for blk in jp["blocks"]:  # non-trivial norms, biases and layer scales
        for leaf in ("norm1", "norm2"):
            blk[leaf]["scale"] = 1 + 0.1 * rng.standard_normal(blk[leaf]["scale"].shape).astype(np.float32)
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * rng.standard_normal(d["bias"].shape).astype(np.float32)
        if layer_scale:
            blk["ls1"] = 0.5 * rng.standard_normal(blk["ls1"].shape).astype(np.float32)
            blk["ls2"] = 0.5 * rng.standard_normal(blk["ls2"].shape).astype(np.float32)
    jp["cls_token"] = 0.1 * rng.standard_normal(jp["cls_token"].shape).astype(np.float32)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp), images


@pytest.mark.parametrize("layer_scale", [False, True])
@pytest.mark.parametrize("schedule", [None, SCHED], ids=["identity", "pruned"])
def test_head_dim80_forward_matches_jax(rng, schedule, layer_scale):
    jcfg, tcfg, jp, tp, images = _setup(rng, layer_scale)
    assert tcfg.embed_dim // tcfg.num_heads == 80
    jparams = jax.tree.map(jnp.asarray, jp)
    jsched = jvit.normalize_schedule(schedule, jcfg.depth)
    jsel, tsel_torch, tsel_cuda = {}, {}, {}
    want_xla = jvit.vit_forward(jparams, jnp.asarray(images), jcfg, jsched, "xla",
                                _sel_tap=lambda i, k: jsel.__setitem__(i, np.asarray(k)))
    want_pallas = jax.jit(jvit.vit_forward, static_argnums=(2, 3, 4))(
        jparams, jnp.asarray(images), jcfg, jsched, "pallas")
    x = torch.from_numpy(images)
    got_torch = tvit.vit_forward(tp, x, tcfg, schedule, "torch",
                                 _sel_tap=lambda i, k: tsel_torch.__setitem__(i, k.numpy()))
    got_cuda = tvit.vit_forward(tp, x, tcfg, schedule, "cuda",
                                _sel_tap=lambda i, k: tsel_cuda.__setitem__(i, k.numpy()))
    np.testing.assert_allclose(got_torch.numpy(), np.asarray(want_xla), **ACT)
    np.testing.assert_allclose(got_cuda.numpy(), np.asarray(want_pallas), **ACT)
    assert sorted(jsel) == sorted(tsel_torch) == sorted(tsel_cuda)
    for i in jsel:
        np.testing.assert_array_equal(tsel_torch[i], jsel[i])
        np.testing.assert_array_equal(tsel_cuda[i], jsel[i])
    stats = tvit.model_stats(tcfg, schedule)
    assert stats == jvit.model_stats(jcfg, jsched)
    assert stats["token_counts"] == ([17, 17, 12, 8] if schedule else [17] * 4)


def _qkv(rng, B, n, H):
    return rng.standard_normal((B, n, 3 * 80 * H)).astype(np.float32)


@pytest.mark.parametrize("n", [17, 90])  # one key tile, and several
def test_head_dim80_fused_sdpa_plain_matches_jax(rng, n):
    qkv = _qkv(rng, 2, n, 2)
    want = jattn.fused_sdpa(jnp.asarray(qkv), 2, SCALE)
    got = tattn.fused_sdpa(torch.from_numpy(qkv), 2, SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_head_dim80_gathered_attention_matches_jax_mha(rng):
    B, n_src, n, H = 2, 90, 63, 2
    qkv = _qkv(rng, B, n_src, H)
    idx = np.sort(np.stack([np.concatenate([[0], 1 + rng.permutation(n_src - 1)[: n - 1]])
                            for _ in range(B)]), axis=1).astype(np.int32)
    got, _ = tattn.short_attention(torch.from_numpy(qkv), torch.from_numpy(idx), H, SCALE,
                                   torch.float32)
    for b in range(B):
        want = jblock._mha(jnp.asarray(qkv[b][idx[b]]), H, SCALE, jnp.float32)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **ACT)


BF16_REL_L2 = 3e-4


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n", [61, 180, 257])  # phased below 4 MiB (n <= 209), per-head above
def test_head_dim80_mha_bf16_takes_jax_form(rng, n):
    H = 16
    qkv = _qkv(rng, 2, n, H)
    got = tblock._mha(torch.from_numpy(qkv).to(torch.bfloat16), H, SCALE, torch.float32)
    assert tattn.mha_phased(H, n, SCALE) == (n <= 209)
    for b in range(2):
        want = np.asarray(jblock._mha(jnp.asarray(qkv[b]).astype(jnp.bfloat16), H, SCALE,
                                      jnp.float32))
        assert _rel_l2(got[b].numpy(), want) <= BF16_REL_L2


def test_head_dim80_kernel_plains_take_the_phased_form_in_bf16(rng):
    """The short-row kernel's and B6's body's plain versions, in the form
    the blocks launch them in (``mha_phased``), against JAX's ``_mha`` on
    the kept rows; the per-head form is far off."""
    B, n_src, n, H = 2, 180, 126, 16
    qkv = torch.from_numpy(_qkv(rng, B, n_src, H)).to(torch.bfloat16)
    idx = torch.from_numpy(np.sort(np.stack([
        np.concatenate([[0], 1 + rng.permutation(n_src - 1)[: n - 1]]) for _ in range(B)]),
        axis=1).astype(np.int32))
    assert tattn.mha_phased(H, n, SCALE)
    short, _ = tattn.short_attention(qkv, idx, H, SCALE, torch.float32)
    body = tattn.attention_route(qkv, idx, H, SCALE, "body")
    assert torch.equal(body, tattn.short_attention(qkv, idx, H, SCALE)[0])
    kept_all = torch.take_along_dim(qkv, idx.long()[..., None], dim=1)
    perhead = tattn._sdpa_perhead(kept_all, H, SCALE, torch.float32)
    for b in range(B):
        kept = kept_all[b].float().numpy()
        want = np.asarray(jblock._mha(jnp.asarray(kept).astype(jnp.bfloat16), H, SCALE,
                                      jnp.float32))
        assert _rel_l2(short[b].numpy(), want) <= BF16_REL_L2
        assert _rel_l2(perhead[b].numpy(), want) > 3 * BF16_REL_L2


def test_mha_phased_matches_the_tpu_switch():
    """The kernels' flag: JAX's 4 MiB switch, at a scale that is not a power
    of two (at 1/8 both forms give the same bits)."""
    assert tattn.mha_phased(16, 209, SCALE) and not tattn.mha_phased(16, 210, SCALE)
    assert tattn.mha_phased(8, 295, SCALE) and not tattn.mha_phased(8, 296, SCALE)
    assert not tattn.mha_phased(12, 61, 64 ** -0.5)


def test_head_dim80_importance_matches_jax(rng):
    B, n, H = 2, 61, 16  # ViT-H's 16 heads of 80
    qkv = _qkv(rng, B, n, H)
    got = tblock._importance_f32(torch.from_numpy(qkv), H)
    for b in range(B):
        want = jblock._importance_f32(jnp.asarray(qkv[b]), H)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_c1280_mlp_and_layer_norm_match_jax(rng):
    C, hidden = 1280, 5120
    x = rng.standard_normal((1, 5, C)).astype(np.float32)
    norm = {"scale": 1 + 0.1 * rng.standard_normal(C).astype(np.float32),
            "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}
    fc = {"fc1": {"kernel": rng.standard_normal((C, hidden)).astype(np.float32) / np.sqrt(C),
                  "bias": 0.1 * rng.standard_normal(hidden).astype(np.float32)},
          "fc2": {"kernel": rng.standard_normal((hidden, C)).astype(np.float32) / np.sqrt(hidden),
                  "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}}
    jnorm = {k: jnp.asarray(v) for k, v in norm.items()}
    tnorm = {k: torch.from_numpy(v) for k, v in norm.items()}
    want = jblock._layer_norm_f32(jnp.asarray(x), jnorm["scale"], jnorm["bias"], 1e-6)
    got = tmlp._layer_norm_f32(torch.from_numpy(x), tnorm["scale"], tnorm["bias"], 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    want = jmlp.fused_ln_mlp_residual(
        jnp.asarray(x), jnorm, {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                                for k, v in fc.items()}, None, 1e-6)
    tmlp_p = {k: {"weight": torch.from_numpy(v["kernel"].T.copy()),
                  "bias": torch.from_numpy(v["bias"])} for k, v in fc.items()}
    got = tmlp.fused_ln_mlp_residual(torch.from_numpy(x), tnorm, tmlp_p, None, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


GIANT = "vit_giant_patch14_224"  # C = 1408


INT8_WIDTHS = "its kernels take head_dim 64 with C <= 1024 or head_dim 80 with C = 1280"


@pytest.mark.parametrize("model,kw,route", [
    ("vit_huge_patch14_224", {}, "route: cuda"),
    ("vit_huge_patch14_224", {"quantized": True}, "route: cuda"),
    ("vit_huge_patch14_224", {"training": True}, "route: cuda"),
    ("vit_huge_patch14_224", {"quantized": True, "training": True}, "route: cuda"),
    (dict(embed_dim=1280, num_heads=20), {"training": True}, "route: cuda"),
    ("vit_large_patch16_224", {"quantized": True, "training": True}, "route: cuda"),
    (dict(embed_dim=640, num_heads=8), {"quantized": True},
     f"route: torch (int8 weights at C=640, head_dim 80: {INT8_WIDTHS})"),
    (dict(embed_dim=1280, num_heads=20), {"quantized": True},
     f"route: torch (int8 weights at C=1280, head_dim 64: {INT8_WIDTHS})"),
    (GIANT, {}, "route: torch (C=1408 > 1280)"),
    (dict(embed_dim=768, num_heads=8), {}, "route: torch (head_dim 96 is not 64 or 80)"),
], ids=["vit_h bf16", "vit_h int8", "vit_h training", "vit_h int8 training",
        "head_dim 64 C=1280 training", "vit_l int8 training", "head_dim 80 C=640 int8",
        "head_dim 64 C=1280 int8", "C=1408", "head_dim 96"])
def test_card_route_takes_vit_h_in_bf16_and_int8(model, kw, route):
    """On a CUDA device ViT-H takes the kernels in bf16 and with int8 params,
    and so does its training (B16-B18 take the bf16 kernels' widths); int8
    params at another head_dim-80 width or past C = 1024 at head_dim 64
    demote before any launch, naming why; on the CPU nothing demotes."""
    config = tvit.get_config(model) if isinstance(model, str) else tvit.ViTConfig(**model)
    for impl in ("auto", "cuda"):
        assert tvit.route_line(*tvit.resolve_route(impl, config, torch.bfloat16, "cuda",
                                                   **kw)) == route
    assert tvit.resolve_route("cuda", config, torch.bfloat16, "cpu", **kw) == ("cuda", "")


def test_the_gate_sees_int8_params():
    """``vit_forward`` and ``RAJNIViT`` hand the gate whether the params are
    int8 (``params_quantized``), which decides ViT-H's demotion."""
    config = tvit.ViTConfig(**CFG)
    params = tvit.init_params(torch.Generator().manual_seed(0), config, torch.float32)
    assert not tvit.params_quantized(params)
    assert tvit.params_quantized(quantize_params(params))
    assert tvit.params_quantized(quantize_params(params, attn=False))
