"""The port's split int8 kernels against the JAX package: B9
``fused_ln_mlp_residual_int8``, B10 ``fused_attn_block_int8``, B12
``fused_ln_qkv_int8`` and B13 ``fused_gather_sdpa_proj_residual_int8``, the
copied fit rules that route them, and narrow forwards that take them.

The JAX kernels run in interpret mode on the CPU, as
tests/test_torch_wholeblock.py runs them, and the port's wrappers take their
plain versions because the tensors lie on the CPU. Inputs come from numpy;
int8 records are the JAX ``quantize_weight``'s, carried across. Tolerances
are test_torch_wholeblock.py's (rtol 1e-4 / atol 1e-5 with ``_int8_close``'s
one-step flip allowance, derived there), atol 1e-6 on scores, kept indices
exact. The JAX results that several cases compare with are computed once per
module (fixtures), to keep the file's time small.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import quant as jquant
from rajni_tpu.kernels import block as jblock
from rajni_tpu.kernels import mlp as jmlp
from rajni_tpu.models import vit as jvit
from rajni_tpu.ops.pruning import select_tokens_dense as jselect
from rajni_tpu_torch import params_from_numpy, quant as tquant
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import mlp as tmlp
from rajni_tpu_torch.kernels import wholeblock as twb
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.ops.pruning import select_tokens_dense as tselect
from tests.test_torch_wholeblock import ACT, _block, _int8_close, _jquantize, _np_params, _spy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

C, HIDDEN, B, N, H, KEEP = 64, 256, 2, 29, 1, 19
SCALE = 64 ** -0.5
STATIC = (4 / 127, 2 / 127, 4 / 127, 3 / 127)  # (a_qkv, a_proj, a_fc1, a_fc2)
_jquantize_mlp = jax.jit(functools.partial(jquant.quantize_params, attn=False))


def _bf16(tree):
    """A JAX block tree in bf16, its int8 records left as they are."""
    if isinstance(tree, dict):
        return tree if "int8" in tree else {k: _bf16(v) for k, v in tree.items()}
    return tree.astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def blk():
    """One int8 block (non-zero biases, layer scales) and its input."""
    rng = np.random.default_rng(11)
    jb, tb = _block(rng, C, HIDDEN, with_ls=True, int8=True)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    return jb, tb, x


@pytest.fixture(scope="module")
def jax_b12(blk):
    """JAX B12 outputs: ``{(static, with_scores): (qkv, scores)}``."""
    jb, _, x = blk
    return {(static, ws): tuple(np.asarray(a) for a in jblock.fused_ln_qkv_int8(
                jnp.asarray(x), jb["norm1"], jb["attn"]["qkv"], H, 1e-6, ws,
                act_scales=STATIC[:2] if static else None))
            for static, ws in ((False, True), (False, False), (True, True))}


# ---------------------------------------------------------------------------
# Fit rules
# ---------------------------------------------------------------------------

VIT_B384_TRACE = [577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356]


def test_split_fit_rules_match_jax():
    pairs = set(zip(VIT_B384_TRACE, VIT_B384_TRACE[1:] + [356]))
    pairs |= {(197, 188), (197, 187), (150, 127), (197, 177), (17, 12), (29, 20), (848, 700)}
    for C_, hidden in ((64, 256), (128, 512), (384, 1536), (768, 3072), (1024, 4096),
                       (1280, 5120), (1664, 8192)):
        for itemsize in (1, 2, 4):
            assert tmlp._hidden_chunk(C_, hidden, itemsize) == jmlp._hidden_chunk(C_, hidden,
                                                                                  itemsize)
            for n, k in pairs:
                args = (n, k, C_, itemsize)
                assert twb._gather_fits_fast(*args) == jblock._gather_fits_fast(*args), args
                assert twb._pruned_block_fits(*args) == jblock._pruned_block_fits(*args), args
    # ViT-B/16 384 int8 (bf16 activations): blocks 3-5 take the bf16 B5 tail,
    # 6-7 B13; no block takes B11; B9 is unchunked; blocks 8-11 take B15
    pruned = list(zip(VIT_B384_TRACE[3:8], VIT_B384_TRACE[4:9]))
    assert [twb._gather_fits_fast(n, k, 768, 2) for n, k in pruned] == [False] * 3 + [True] * 2
    assert not any(twb._pruned_block_fits(n, k, 768, 2) for n, k in pruned)
    assert all(twb._pruned_full_int8_plan(n, k, 768, 3072, 2) is None for n, k in pruned)
    assert twb._block_full_int8_plan(356, 768, 3072, 2) == (1, 1536)
    assert twb._block_full_int8_plan(577, 768, 3072, 2) is None
    assert tmlp._hidden_chunk(768, 3072, 1) == 3072
    # B11's paths: ViT-L/16 224 and DeiT-S/16 384 (the one-kernel route fits)
    assert twb._pruned_block_fits(197, 188, 1024, 2) and twb._pruned_block_fits(577, 548, 384, 2)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hc_part", [1, 2], ids=["hc=hidden", "hc=hidden/2"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_b9_ln_mlp_residual_int8_matches_pallas(blk, monkeypatch, static, hc_part):
    """hc < hidden is forced through both packages' ``_WEIGHT_BUDGET``, as
    tests/test_quant.py forces the JAX chunked kernel; the JAX kernel reads
    the budget when it traces, so its jit cache is cleared around the call."""
    jb, tb, x = blk
    if hc_part == 2:
        for mod in (jmlp, tmlp):
            monkeypatch.setattr(mod, "_WEIGHT_BUDGET", 2 * C * HIDDEN - 1)
    assert tmlp._hidden_chunk(C, HIDDEN, 1) == jmlp._hidden_chunk(C, HIDDEN, 1) == HIDDEN // hc_part
    scales = STATIC[2:] if static else None
    jmlp.fused_ln_mlp_residual_int8.clear_cache()
    try:
        want = jmlp.fused_ln_mlp_residual_int8(jnp.asarray(x), jb["norm2"], jb["mlp"], jb["ls2"],
                                               act_scales=scales)
    finally:
        jmlp.fused_ln_mlp_residual_int8.clear_cache()
    got = tmlp.fused_ln_mlp_residual_int8(torch.from_numpy(x), tb["norm2"], tb["mlp"], tb["ls2"],
                                          act_scales=scales)
    _int8_close(got.numpy(), want, f"B9 static={static} hc={HIDDEN // hc_part}")


@pytest.mark.parametrize("mode", ["dynamic", "static", "bf16"])
def test_b10_attn_block_int8_matches_pallas(blk, monkeypatch, mode):
    """In bf16 the TPU kernel rounds its attention output to bf16 before it
    quantizes it (``block.py:1255``); the port's plain version does the same,
    and the same plain version with an fp32 attention output (the fault the
    bf16 case pins; in fp32 the two are one function) moves far more
    outputs than the flip allowance."""
    jb, tb, x = blk
    scales = STATIC[:2] if mode == "static" else None
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if mode == "bf16":
        jb, tb = _bf16(jb), tvit.tree_to(tb, dtype=torch.bfloat16)
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(jblock.fused_attn_block_int8(jx, jb["norm1"], jb["attn"], jb["ls1"], H,
                                                   SCALE, act_scales=scales), np.float32)
    args = (tx, tb["norm1"], tb["attn"], tb["ls1"], H, SCALE, 1e-6, scales)
    got = tblock.fused_attn_block_int8(*args)
    _int8_close(got.float().numpy(), want, f"B10 {mode}")
    if mode != "bf16":
        return
    sound = tblock._mha
    monkeypatch.setattr(tblock, "_mha", lambda q, h, s, dt: sound(q, h, s, torch.float32))
    bad = tblock.attn_block_int8_plain(*args).float().numpy()
    assert (~np.isclose(bad, want, **ACT)).mean() > 0.1


@pytest.mark.parametrize("static,with_scores", [(False, True), (False, False), (True, True)],
                         ids=["dynamic-scores", "dynamic-no-scores", "static-V-fold"])
def test_b12_ln_qkv_int8_matches_pallas(blk, jax_b12, static, with_scores):
    jb, tb, x = blk
    want_qkv, want_s = jax_b12[(static, with_scores)]
    got_qkv, got_s = tblock.fused_ln_qkv_int8(torch.from_numpy(x), tb["norm1"], tb["attn"]["qkv"],
                                              H, 1e-6, with_scores,
                                              STATIC[:2] if static else None)
    _int8_close(got_qkv.numpy(), want_qkv, f"B12 static={static}")
    if with_scores:
        np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-6)
    else:
        assert not got_s.any()


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_b13_gather_sdpa_proj_residual_int8_matches_pallas(blk, jax_b12, static):
    """On B12's qkv (V folded under static scales), with the port's kept
    indices from the port's ``select_tokens_dense``."""
    jb, tb, x = blk
    qkv, scores = jax_b12[(static, True)]
    keep_idx, _ = tselect(torch.tensor(scores), KEEP, torch.bool)
    jidx, sel = jselect(jnp.asarray(scores), KEEP, jnp.float32)
    np.testing.assert_array_equal(keep_idx.numpy(), np.asarray(jidx))
    a_proj = STATIC[1] if static else None
    want = jblock.fused_gather_sdpa_proj_residual_int8(
        jnp.asarray(qkv), sel, jnp.asarray(x), jb["attn"]["proj"], jb["ls1"], H, SCALE,
        act_scale=a_proj)
    got = tblock.fused_gather_sdpa_proj_residual_int8(
        torch.tensor(qkv), keep_idx, torch.from_numpy(x), tb["attn"]["proj"], tb["ls1"], H,
        SCALE, a_proj)
    _int8_close(got.numpy(), want, f"B13 static={static}")


# ---------------------------------------------------------------------------
# Narrow forwards through the split int8 routes
# ---------------------------------------------------------------------------

CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=3, num_heads=2, num_classes=10)
# block 0 rescoring at 17 tokens, block 1 threading its scores at 12, block 2 stock
SCHED = {0: {"keep_ratio": 0.7, "update": True}, 1: {"keep_ratio": 0.8, "update": False}}
SPLIT = ("fused_ln_qkv_int8", "fused_gather_sdpa_proj_residual",
         "fused_gather_sdpa_proj_residual_int8", "fused_attn_block_int8",
         "fused_pruned_attn_block", "fused_attn_block")


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return _np_params(rng, CFG), images


def _route_split(monkeypatch):
    """Send the narrow int8 forward down the split routes in both packages:
    no whole-block plan, no one-kernel pruned half (B11), and the tail chosen
    by token count, since at this width ``_gather_fits_fast`` holds
    everywhere: 17 tokens take the bf16 B5 tail, 12 the int8 B13."""
    fits_fast = lambda n, k, c, itemsize: n < 17  # noqa: E731
    for mod, names in ((jblock, ("_full_block_fits_int8", "_block_full_int8_fits")),
                       (tvit, ("_pruned_full_int8_plan", "_block_full_int8_plan"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a: None)
        monkeypatch.setattr(mod, "_pruned_block_fits", lambda *a: False)
        monkeypatch.setattr(mod, "_gather_fits_fast", fits_fast)


@pytest.mark.parametrize("mode", ["dynamic", "static", "MLP-only"])
def test_narrow_split_int8_forward_matches_jax(narrow, monkeypatch, mode):
    """C=128, 2 heads, depth 3: ``impl="cuda"`` (plain versions) against
    JAX ``"pallas"``, with the same routes on both sides and the same kept
    tokens. The int8 routes are forced as :func:`_route_split` says; the
    MLP-only forward takes its natural route (K1, K1, K2, each with B9).
    Static scales are the port's calibration on these images, given to
    both."""
    jp, images = narrow
    jcfg, tcfg = jvit.ViTConfig(**CFG), tvit.ViTConfig(**CFG)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    tp = params_from_numpy(jp)
    x = torch.from_numpy(images)
    scales = tscales = None
    if mode == "static":
        tscales = tquant.calibrate_act_scales(tp, x, tcfg, SCHED)
        scales = jquant.ActScales(tuple(map(tuple, tscales.blocks)), tscales.head)
    quantize = _jquantize if mode != "MLP-only" else _jquantize_mlp
    jq = jax.tree.map(np.asarray, quantize(jax.tree.map(jnp.asarray, jp)))
    if mode != "MLP-only":
        _route_split(monkeypatch)
    jcalls, tcalls, jsel, tsel = [], [], {}, {}
    _spy(monkeypatch, jblock, SPLIT, jcalls)
    _spy(monkeypatch, jmlp, ("fused_ln_mlp_residual_int8",), jcalls)
    _spy(monkeypatch, tvit, SPLIT + ("fused_ln_mlp_residual_int8",), tcalls)
    want = jvit.vit_forward(jax.tree.map(jnp.asarray, jq), jnp.asarray(images), jcfg, jsched,
                            "pallas", scales,
                            _sel_tap=lambda i, k: jsel.__setitem__(i, np.asarray(k)))
    got = tvit.vit_forward(params_from_numpy(jq), x, tcfg, SCHED, "cuda", tscales,
                           _sel_tap=lambda i, k: tsel.__setitem__(i, k.numpy()))
    _int8_close(got.numpy(), want, mode)
    mlp = ["fused_ln_mlp_residual_int8"]
    if mode == "MLP-only":
        route = ["fused_pruned_attn_block"] + mlp + ["fused_pruned_attn_block"] + mlp
        route += ["fused_attn_block"] + mlp
        # JAX's one-kernel route taps no selection: hold its next_scores
        for j, t in ((0, 0), (2, 2)):
            np.testing.assert_allclose(tcalls[t][1].numpy(), np.asarray(jcalls[j][1]), atol=1e-6)
    else:
        route = ["fused_ln_qkv_int8", "fused_gather_sdpa_proj_residual"] + mlp
        route += ["fused_ln_qkv_int8", "fused_gather_sdpa_proj_residual_int8"] + mlp
        route += ["fused_attn_block_int8"] + mlp
        assert sorted(jsel) == sorted(tsel) == [0, 1]
        for i in (0, 1):
            np.testing.assert_array_equal(tsel[i], jsel[i])
    assert [c[0] for c in jcalls] == route
    assert [c[0] for c in tcalls] == route
