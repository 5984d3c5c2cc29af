"""The port's int8 kernels at ViT-H/14's widths (C = 1280, head_dim 80)
against the JAX package.

A narrow ViT-H-shaped forward (C = 160, 2 heads of 80, hidden 640, 56 px
images in 14 px patches: 17 tokens, depth 4, keep 0.7 at blocks 1 and 2) with
int8 params, dynamic and static: ``impl="cuda"`` (the kernels' plain
versions on CPU tensors) against JAX ``"pallas"`` in interpret mode, the
split routes forced in both packages (B10 + B9 in the stock blocks, B12 +
selection + B13 + B9 in the pruned ones, as ViT-H/14 routes them at
``VIT_H_PROBE``). Then, at C = 1280 itself: the int8 LayerNorm's summation
order (``kernels/mlp.py:_layer_norm_int8``, the card's ``ln_quant_kernel``
with 5 vectors a lane) against a numpy copy of that order, bit for bit, and
against JAX's LayerNorm and quantizer; the plain B9 (hidden 5120, hc 1280)
and B12 (16 heads) against the JAX kernels; the int8 tails' attention with
its row absmax at head_dim 80, in both SDPA forms; and the fit rules that
keep ViT-H/14 off the whole-block kernels.

Tolerances are tests/test_torch_wholeblock.py's: rtol 1e-4 / atol 1e-5 with
``_int8_close``'s one-step flip allowance, atol 1e-6 on scores, selections
and token counts exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import quant as jquant
from rajni_tpu.kernels import block as jblock
from rajni_tpu.kernels import math as jmath
from rajni_tpu.kernels import mlp as jmlp
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy, quant as tquant
from rajni_tpu_torch.kernels import attention as tattn
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import mlp as tmlp
from rajni_tpu_torch.kernels import wholeblock as twb
from rajni_tpu_torch.kernels.math import quantize_rows
from rajni_tpu_torch.models import vit as tvit
from tests.test_torch_int8_split import _route_split
from tests.test_torch_wholeblock import ACT, _block, _int8_close, _jquantize, _np_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFG = dict(img_size=56, patch_size=14, embed_dim=160, depth=4, num_heads=2, num_classes=10)
SCHED = {1: {"keep_ratio": 0.7}, 2: {"keep_ratio": 0.7}}
SCALE = 80 ** -0.5
C_H, H_H, HIDDEN_H = 1280, 16, 5120  # ViT-H/14
STATIC = (4 / 127, 2 / 127, 4 / 127, 3 / 127)  # (a_qkv, a_proj, a_fc1, a_fc2)
# the kernels the split routes run, spied on in both packages
SPLIT = ("fused_ln_qkv_int8", "fused_gather_sdpa_proj_residual_int8", "fused_attn_block_int8")


def _route_vit_h(monkeypatch):
    """Send both packages' int8 forwards down ViT-H/14's routes: no
    whole-block plan, no one-kernel pruned half (B11), and the int8 tail B13
    in every pruned block (at this narrow width JAX's VMEM rules would fit
    the whole blocks)."""
    _route_split(monkeypatch)
    for mod in (jblock, tvit):
        monkeypatch.setattr(mod, "_gather_fits_fast", lambda *a: True)


def _spy(monkeypatch, module, names, calls):
    """Record each call of ``names`` in ``module``: its name and output (the
    first element of a tuple: the activations, or B12's qkv), and B12's
    scores."""
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            first = out[0] if isinstance(out, tuple) else out
            calls.append((_name, np.asarray(first, np.float32),
                          np.asarray(out[1]) if _name == "fused_ln_qkv_int8" else None))
            return out

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_narrow_vit_h_int8_forward_matches_jax(monkeypatch, mode):
    """Each kernel call's output on both sides (every block's activations,
    B12's qkv and scores), the kept tokens and the logits. Static scales are
    the port's calibration on these images, given to both."""
    rng = np.random.default_rng(15)
    jp = _np_params(rng, CFG)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    jcfg, tcfg = jvit.ViTConfig(**CFG), tvit.ViTConfig(**CFG)
    assert tcfg.embed_dim // tcfg.num_heads == 80 and tcfg.mlp_hidden == 640
    x = torch.from_numpy(images)
    scales = tscales = None
    if mode == "static":
        tscales = tquant.calibrate_act_scales(params_from_numpy(jp), x, tcfg, SCHED)
        scales = jquant.ActScales(tuple(map(tuple, tscales.blocks)), tscales.head)
    jq = jax.tree.map(np.asarray, _jquantize(jax.tree.map(jnp.asarray, jp)))
    _route_vit_h(monkeypatch)
    jcalls, tcalls, jsel, tsel = [], [], {}, {}
    _spy(monkeypatch, jblock, SPLIT, jcalls)
    _spy(monkeypatch, jmlp, ("fused_ln_mlp_residual_int8",), jcalls)
    _spy(monkeypatch, tvit, SPLIT + ("fused_ln_mlp_residual_int8",), tcalls)
    want = jvit.vit_forward(jax.tree.map(jnp.asarray, jq), jnp.asarray(images), jcfg,
                            jvit.normalize_schedule(SCHED, jcfg.depth), "pallas", scales,
                            _sel_tap=lambda i, k: jsel.__setitem__(i, np.asarray(k)))
    got = tvit.vit_forward(params_from_numpy(jq), x, tcfg, SCHED, "cuda", tscales,
                           _sel_tap=lambda i, k: tsel.__setitem__(i, k.numpy()))
    mlp = ["fused_ln_mlp_residual_int8"]
    pruned = ["fused_ln_qkv_int8", "fused_gather_sdpa_proj_residual_int8"] + mlp
    route = ["fused_attn_block_int8"] + mlp + pruned + pruned + ["fused_attn_block_int8"] + mlp
    assert [c[0] for c in jcalls] == [c[0] for c in tcalls] == route
    for (name, jout, js), (_, tout, ts) in zip(jcalls, tcalls):
        _int8_close(tout, jout, f"{mode} {name}")
        if js is not None:
            np.testing.assert_allclose(ts, js, atol=1e-6)
    assert sorted(jsel) == sorted(tsel) == [1, 2]
    for i in (1, 2):
        np.testing.assert_array_equal(tsel[i], jsel[i])
    assert tvit.model_stats(tcfg, SCHED)["token_counts"] == [17, 17, 12, 8]
    _int8_close(got.numpy(), want, f"{mode} logits")


# ---------------------------------------------------------------------------
# C = 1280: the int8 LayerNorm, B9, B12
# ---------------------------------------------------------------------------


def _kernel_order_ln(x, scale, bias, eps):
    """The card's ``ln_quant_kernel`` in numpy fp32, written out: lane l adds
    its elements 8c..8c+7 of chunks c = l, l + 32, ... (4 a lane up to C =
    1024, 5 past it) in turn, the lanes are added by the xor butterfly, mean
    = sum / C, rstd = 1 / sqrt(var / C + eps), y = ((x - mean) · rstd) ·
    scale + bias, each operation rounded to fp32."""
    R, C = x.shape
    nv, vectors = C // 8, 4 if C <= 1024 else 5
    f32 = np.float32

    def lane_sum(v):
        s = np.zeros((R, 32), f32)
        for i in range(vectors):
            for lane in range(32):
                c = lane + 32 * i
                if c < nv:
                    for j in range(8):
                        s[:, lane] = s[:, lane] + v[:, 8 * c + j]
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, np.arange(32) ^ o]
        return s[:, :1]

    mean = lane_sum(x) / f32(C)
    d = x - mean
    rstd = f32(1) / np.sqrt(lane_sum(d * d) / f32(C) + f32(eps))
    return ((x - mean) * rstd) * scale + bias


@pytest.mark.parametrize("C", [768, 1024, 1280])
def test_layer_norm_int8_keeps_the_kernel_order(C):
    """Bit for bit the kernel's order (at 768 and 1024 the order it always
    had, at 1280 with 5 chunks a lane); within rtol 1e-4 / atol 1e-5 of
    JAX's LayerNorm; its int8 rows and row scales within ``_int8_close`` of
    JAX's quantizer of JAX's LayerNorm."""
    rng = np.random.default_rng(C)
    x = (3 * rng.standard_normal((6, C)) + rng.standard_normal((6, 1))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    got = tmlp._layer_norm_int8(*(torch.from_numpy(a) for a in (x, scale, bias)), 1e-6)
    np.testing.assert_array_equal(got.numpy(), _kernel_order_ln(x, scale, bias, 1e-6))
    want = jblock._layer_norm_f32(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    q, a = quantize_rows(got)
    jq, ja = jmath.quantize_rows(want)
    _int8_close(q.numpy(), np.asarray(jq), f"int8 rows C={C}")
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **ACT)


@pytest.fixture(scope="module")
def vit_h_block():
    """One int8 block at ViT-H/14's widths (non-zero biases, layer scales)
    and a few rows of input."""
    rng = np.random.default_rng(14)
    jb, tb = _block(rng, C_H, HIDDEN_H, with_ls=True, int8=True)
    x = rng.standard_normal((1, 9, C_H)).astype(np.float32)
    return jb, tb, x


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_b9_at_c1280_matches_pallas(vit_h_block, static):
    """hc = 1280 of hidden 5120 in both packages: four row scales a row in
    dynamic mode, the chunked TPU kernel's numerics."""
    jb, tb, x = vit_h_block
    assert tmlp._hidden_chunk(C_H, HIDDEN_H, 1) == jmlp._hidden_chunk(C_H, HIDDEN_H, 1) == 1280
    scales = STATIC[2:] if static else None
    want = jmlp.fused_ln_mlp_residual_int8(jnp.asarray(x), jb["norm2"], jb["mlp"], jb["ls2"],
                                           act_scales=scales)
    got = tmlp.fused_ln_mlp_residual_int8(torch.from_numpy(x), tb["norm2"], tb["mlp"], tb["ls2"],
                                          act_scales=scales)
    _int8_close(got.numpy(), want, f"B9 C=1280 static={static}")


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static-V-fold"])
def test_b12_at_c1280_matches_pallas(vit_h_block, static):
    jb, tb, x = vit_h_block
    scales = STATIC[:2] if static else None
    want_qkv, want_s = jblock.fused_ln_qkv_int8(jnp.asarray(x), jb["norm1"], jb["attn"]["qkv"],
                                                H_H, 1e-6, True, act_scales=scales)
    got_qkv, got_s = tblock.fused_ln_qkv_int8(torch.from_numpy(x), tb["norm1"], tb["attn"]["qkv"],
                                              H_H, 1e-6, True, scales)
    _int8_close(got_qkv.numpy(), want_qkv, f"B12 C=1280 static={static}")
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)


# ---------------------------------------------------------------------------
# The int8 tails' attention with its row absmax at head_dim 80
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [61, 180, 257])  # phased below 4 MiB (n <= 209), per-head above
def test_head_dim80_tail_attention_absmax_matches_jax_mha(n):
    """The plain versions of the short-row kernel (n <= 256) and of B6's
    body (257) with the row absmax, fp32 out, gathered (a shuffled CLS-first
    order of 257 tokens), against JAX's ``_mha`` on the kept rows and the
    row absmax of its output."""
    rng = np.random.default_rng(n)
    B, n_src = 1, 257
    assert tattn.mha_phased(H_H, n, SCALE) == (n <= 209)
    qkv = rng.standard_normal((B, n_src, 3 * C_H)).astype(np.float32)
    idx = np.concatenate([[0], 1 + rng.permutation(n_src - 1)[: n - 1]])[None].astype(np.int32)
    attend = tattn.short_attention if n <= tattn.ATTN_MAX_N else tattn.body_attention
    got, amax = attend(torch.from_numpy(qkv), torch.from_numpy(idx), H_H, SCALE, torch.float32,
                       True)
    want = np.asarray(jblock._mha(jnp.asarray(qkv[0][idx[0]]), H_H, SCALE, jnp.float32))
    np.testing.assert_allclose(got[0].numpy(), want, **ACT)
    np.testing.assert_allclose(amax.numpy(), np.abs(want).max(axis=-1), **ACT)


# ---------------------------------------------------------------------------
# Fit rules and the wrappers' width checks at C = 1280
# ---------------------------------------------------------------------------

VIT_H_TRACE = [257] * 6 + [180] * 5 + [126] * 5 + [88] * 5 + [61] * 11
VIT_H_PRUNED = ((257, 180), (180, 126), (126, 88), (88, 61))


def test_vit_h_int8_fit_rules():
    """Neither whole-block int8 plan fits at C = 1280 for any 2 <= K <= n <=
    384, so the route never sends ViT-H/14 to B14 or B15 (whose wrappers
    keep head_dim 64); at VIT_H_PROBE's pruned blocks B11's one-kernel route
    does not fit and the int8 tail B13 does, as in JAX; B11 fits at 30→21."""
    for n in range(2, 385):
        assert twb._block_full_int8_plan(n, C_H, HIDDEN_H, 2) is None, n
        assert all(twb._pruned_full_int8_plan(n, k, C_H, HIDDEN_H, 2) is None
                   for k in range(2, n + 1)), n
    for n, k in VIT_H_PRUNED + ((30, 21),):
        args = (n, k, C_H, 2)
        assert twb._pruned_block_fits(*args) == jblock._pruned_block_fits(*args) == (n == 30)
        assert twb._gather_fits_fast(*args) and jblock._gather_fits_fast(*args)
    for n, k in zip(VIT_H_TRACE, VIT_H_TRACE[1:] + [61]):  # JAX's own rules, on the trace
        assert not jblock._block_full_int8_fits(n, C_H, HIDDEN_H, 2)
        assert not jblock._full_block_fits_int8(n, k, C_H, HIDDEN_H, 2)
    assert tvit.model_stats(tvit.get_config("vit_huge_patch14_224"),
                            dict.fromkeys((5, 10, 15, 20), {"keep_ratio": 0.7})
                            )["token_counts"] == VIT_H_TRACE


def test_int8_widths_and_the_whole_blocks_checks():
    """The int8 attention kernels take head_dim 80 at C = 1280 only; the
    whole blocks (B14, B15) and B16 keep head_dim 64 with C <= 1024."""
    tblock._check_attn_shapes("B10", 257, C_H, H_H, 848, "int8")
    for C, H in ((640, 8), (1280, 20), (1408, 16)):
        with pytest.raises(ValueError):
            tblock._check_attn_shapes("B10", 257, C, H, 848, "int8")
    tblock._check_attn_shapes("B10", 197, 1024, 16, 848, "int8")
    with pytest.raises(ValueError):
        twb._check_shapes("fused_block_full_int8", torch.empty(1, 257, C_H), H_H, HIDDEN_H, 848)
    with pytest.raises(ValueError):
        tblock._check_attn_shapes("train_attn_block", 257, C_H, H_H, 848)
