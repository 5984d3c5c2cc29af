"""The port's whole-block slice against the JAX package: B7
``fused_pruned_block_full``, B8 ``fused_attn_mlp_block``, B14
``fused_pruned_block_full_int8``, B15 ``fused_block_full_int8``, the int8
quantization helpers, the copied fit rules, and narrow forwards in bf16-free
fp32 with and without int8 params.

The JAX kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them; the port's wrappers take their plain versions because the tensors
lie on the CPU. Inputs come from numpy. Tolerances: rtol 1e-4 / atol 1e-5 on
activations and logits (tests/test_kernels.py), atol 1e-6 on scores, kept
indices exactly.

Int8 tolerance. The int8 products are exact on both sides and the dequant
multiplies in the same order, so the outputs agree to fp32 rounding unless
an activation lies within an fp32 rounding of a quantization tie and the two
frameworks, summing LayerNorm or attention in another order, round it to
neighbouring int8 values: a one-step flip. It moves a product by one int8
step of its row times a weight, ``a_row · |w|``; here activations reach ~5
(a_row ≈ 5/127 ≈ 0.04) and |w| < 0.5, so a flip moves an output by less than
``INT8_FLIP`` = 0.05, and only the rows that read it. :func:`_int8_close`
therefore allows up to 2% of the elements outside rtol 1e-4 / atol 1e-5,
each within INT8_FLIP. (At the seeds used here no flip occurs.)
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import quant as jquant
from rajni_tpu.kernels import block as jblock
from rajni_tpu.kernels import math as jmath
from rajni_tpu.models import vit as jvit
from rajni_tpu.ops.pruning import select_tokens_dense
from rajni_tpu_torch import params_from_numpy, quant as tquant
from rajni_tpu_torch.kernels import math as tmath
from rajni_tpu_torch.kernels import wholeblock as twb
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.utils.schedule import REFERENCE_SCHEDULE


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parent.parent
ACT = dict(rtol=1e-4, atol=1e-5)
INT8_FLIP = 5e-2
B, N, H = 2, 29, 1
SCALE = 64 ** -0.5
STATIC = (4 / 127, 2 / 127, 4 / 127, 3 / 127)  # (a_qkv, a_proj, a_fc1, a_fc2)


def _int8_close(got, want, what: str = "") -> None:
    got, want = np.asarray(got), np.asarray(want)
    bad = ~np.isclose(got, want, **ACT)
    assert bad.mean() <= 0.02, f"{what}: {bad.sum()} of {bad.size} elements off"
    if bad.any():
        assert np.abs(got - want)[bad].max() <= INT8_FLIP, what


def _block(rng, C: int, hidden: int, with_ls: bool = False, int8: bool = False):
    """One random block as a JAX tree and as the port's tree; int8 quantizes
    qkv, proj, fc1 and fc2 with the JAX ``quantize_weight`` (the port's
    records then come through ``params_from_numpy``'s conversion)."""
    from rajni_tpu_torch.params.from_jax import _dense, _norm

    def dense(fi, fo):
        d = {"kernel": rng.standard_normal((fi, fo)).astype(np.float32) / np.sqrt(fi),
             "bias": rng.standard_normal(fo).astype(np.float32) * 0.1}
        if int8:
            d["kernel"] = jax.tree.map(np.asarray, jquant.quantize_weight(jnp.asarray(d["kernel"])))
        return d

    def norm():
        return {"scale": 1 + 0.1 * rng.standard_normal(C).astype(np.float32),
                "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}

    jb = {"norm1": norm(), "attn": {"qkv": dense(C, 3 * C), "proj": dense(C, C)},
          "norm2": norm(), "mlp": {"fc1": dense(C, hidden), "fc2": dense(hidden, C)}}
    tb = {"norm1": _norm(jb["norm1"]), "norm2": _norm(jb["norm2"]),
          "attn": {k: _dense(v) for k, v in jb["attn"].items()},
          "mlp": {k: _dense(v) for k, v in jb["mlp"].items()}}
    if with_ls:
        for name in ("ls1", "ls2"):
            jb[name] = (0.5 * rng.standard_normal(C)).astype(np.float32)
            tb[name] = torch.from_numpy(jb[name])
    return jax.tree.map(jnp.asarray, jb), tb


# ---------------------------------------------------------------------------
# Fit rules and quantization helpers
# ---------------------------------------------------------------------------

VIT_B_TRACE = [197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120]
DEIT_S_TRACE = [197, 197, 197, 197, 177, 159, 143, 128, 115, 103, 92, 82]


def test_plans_match_jax():
    pairs = set(zip(VIT_B_TRACE, VIT_B_TRACE[1:] + [120]))
    pairs |= set(zip(DEIT_S_TRACE, DEIT_S_TRACE[1:] + [74]))
    pairs |= {(577, 577), (577, 548), (548, 520), (442, 375), (29, 20), (17, 10)}
    for C, hidden in ((64, 256), (128, 512), (384, 1536), (768, 3072), (1024, 4096),
                      (1280, 5120)):
        for itemsize in (2, 4):
            for n, k in pairs:
                args = (n, k, C, hidden, itemsize)
                assert twb._bf16_full_plan(*args) == jblock._bf16_full_plan(*args), args
                assert twb._pruned_full_int8_plan(*args) == jblock._pruned_full_int8_plan(*args), args
                assert (twb._attn_mlp_block_fits(n, C, hidden, itemsize)
                        == jblock._attn_mlp_block_fits(n, C, hidden, itemsize)), args
                assert (twb._block_full_int8_plan(n, C, hidden, itemsize)
                        == jblock._block_full_int8_plan(n, C, hidden, itemsize)), args
    # the routes of the slice's paths (bf16 itemsize 2)
    vit_b = [twb._pruned_full_int8_plan(n, k, 768, 3072, 2)
             for n, k in zip(VIT_B_TRACE[3:8], VIT_B_TRACE[4:9])]
    assert vit_b == [(1, 3072)] * 3 + [(2, 1536)] * 2
    assert twb._block_full_int8_plan(197, 768, 3072, 2) == (2, 1536)
    assert twb._bf16_full_plan(197, 187, 768, 3072, 2) is None
    assert not twb._attn_mlp_block_fits(197, 768, 3072, 2)
    deit = [(n, k) for n, k in zip(DEIT_S_TRACE[3:11], DEIT_S_TRACE[4:12])]
    assert all(twb._bf16_full_plan(n, k, 384, 1536, 2) == 4 for n, k in deit)
    assert twb._attn_mlp_block_fits(197, 384, 1536, 2)
    assert all(twb._pruned_full_int8_plan(n, k, 384, 1536, 2) == (4, 768) for n, k in deit)
    assert twb._block_full_int8_plan(197, 384, 1536, 2)[1] == 768
    # the int8 configurations whose JAX route is the split kernels (B9-B13)
    assert twb._pruned_full_int8_plan(577, 548, 768, 3072, 2) is None  # ViT-B/384
    assert twb._block_full_int8_plan(577, 768, 3072, 2) is None
    assert twb._block_full_int8_plan(197, 1024, 4096, 2) is None  # ViT-L


def _np_params(rng, cfg: dict) -> dict:
    """A random ``rajni_tpu`` parameter tree in numpy (the layout of
    ``rajni_tpu.models.vit.init_params``), with non-trivial norms and
    biases."""
    C, P, depth = cfg["embed_dim"], cfg["patch_size"], cfg["depth"]
    n_tok = (cfg["img_size"] // P) ** 2 + 1

    def dense(fi, fo):
        return {"kernel": (rng.standard_normal((fi, fo)) / np.sqrt(fi)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(fo)).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}

    return {"patch_embed": dense(P * P * 3, C),
            "cls_token": (0.1 * rng.standard_normal((1, 1, C))).astype(np.float32),
            "pos_embed": (0.02 * rng.standard_normal((1, n_tok, C))).astype(np.float32),
            "blocks": [{"norm1": norm(), "attn": {"qkv": dense(C, 3 * C), "proj": dense(C, C)},
                        "norm2": norm(),
                        "mlp": {"fc1": dense(C, 4 * C), "fc2": dense(4 * C, C)}}
                       for _ in range(depth)],
            "head": dense(C, cfg["num_classes"]), "norm": norm()}


_jquantize = jax.jit(jquant.quantize_params)


def test_quantize_weight_and_params_match_jax(rng):
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=1, num_classes=10)
    jp = _np_params(rng, cfg)
    jq = jax.tree.map(np.asarray, _jquantize(jax.tree.map(jnp.asarray, jp)))
    tq = tquant.quantize_params(params_from_numpy(jp))
    via_numpy = params_from_numpy(jq)  # the JAX int8 records carried across
    layers = [("head",)] + [("blocks", i, grp, name) for i in range(2)
                            for grp, name in (("attn", "qkv"), ("attn", "proj"),
                                              ("mlp", "fc1"), ("mlp", "fc2"))]
    for path in layers:
        want, got = via_numpy, tq
        for k in path:
            want, got = want[k], got[k]
        want, got = want["weight"], got["weight"]
        assert got["int8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["int8"].numpy(), want["int8"].numpy(), err_msg=str(path))
        np.testing.assert_allclose(got["scale"].numpy(), want["scale"].numpy(), rtol=1.2e-7)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    wq = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_allclose(tquant.dequantize_weight(wq).numpy().T,
                               np.asarray(jquant.dequantize_weight(jquant.quantize_weight(jnp.asarray(w)))),
                               rtol=1e-7)
    with pytest.raises(ValueError, match="already quantized"):
        tquant.quantize_params(tq)
    # tree_to keeps the int8 records' dtypes
    moved = tvit.tree_to(tq, dtype=torch.bfloat16)
    assert moved["head"]["weight"]["int8"].dtype == torch.int8
    assert moved["head"]["weight"]["scale"].dtype == torch.float32
    assert moved["head"]["bias"].dtype == torch.bfloat16


def test_quantizers_and_folds_match_jax(rng):
    y = rng.standard_normal((6, 40)).astype(np.float32) * 3
    # exact .5 ties: absmax 127 makes the multiplier exactly 1
    y[0] = np.concatenate([[127.0, -127.0], np.arange(-19, 19) + 0.5]).astype(np.float32)
    y[1, :] = 0.0  # absmax floored at 1e-8
    y[2] = np.linspace(-63.5, 63.5, 40).astype(np.float32)
    jq, js = jmath.quantize_rows(jnp.asarray(y))
    tq, ts = tmath.quantize_rows(torch.from_numpy(y))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for inv in (None, 2.0, 0.37):
        np.testing.assert_array_equal(
            tmath.quantize_static(torch.from_numpy(y), inv).numpy(),
            np.asarray(jmath.quantize_static(jnp.asarray(y), inv)))
    C = 16
    vec = lambda n: rng.standard_normal(n).astype(np.float32)  # noqa: E731
    lns, lnb, sqkv, sproj, bqkv = vec(C), vec(C), np.abs(vec(3 * C)), np.abs(vec(C)), vec(3 * C)
    want = jmath.fold_static_attn(jnp.asarray(lns[None]), jnp.asarray(lnb[None]),
                                  jnp.asarray(sqkv[None]), jnp.asarray(sproj[None]),
                                  jnp.asarray(bqkv[None]), 0.03, 0.011)
    got = tmath.fold_static_attn(*map(torch.from_numpy, (lns, lnb, sqkv, sproj, bqkv)), 0.03, 0.011)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])
    s1, s2 = np.abs(vec(64)), np.abs(vec(C))
    want = jmath.fold_static_mlp(jnp.asarray(lns[None]), jnp.asarray(lnb[None]),
                                 jnp.asarray(s1[None]), jnp.asarray(s2[None]), 64, 0.02, 0.05)
    got = tmath.fold_static_mlp(*map(torch.from_numpy, (lns, lnb, s1, s2)), 64, 0.02, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])


# ---------------------------------------------------------------------------
# B7, B8 (bf16 whole blocks; fp32 here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_ls,with_scores", [(False, True), (True, False)],
                         ids=["rescored", "threaded-ls"])
def test_b7_pruned_block_full_matches_pallas(rng, with_scores, with_ls):
    jb, tb = _block(rng, 64, 256, with_ls)
    keep = 17
    x = rng.standard_normal((B, N, 64)).astype(np.float32)
    prev = rng.random((B, N)).astype(np.float32)
    jx = jnp.asarray(x)
    want_x, want_ns = jblock.fused_pruned_block_full(jx, jb, jnp.asarray(prev), H, keep, SCALE,
                                                     1e-6, with_scores)
    got_x, got_ns, got_idx = twb.fused_pruned_block_full(
        torch.from_numpy(x), tb, torch.from_numpy(prev), H, keep, SCALE, 1e-6, with_scores)
    # the Pallas kernel keeps its selection inside; recompute it from the
    # JAX scores (LN+QKV's in-pass scores, or the threaded ones)
    if with_scores:
        _, scores = jblock.fused_ln_qkv(jx, jb["norm1"], jb["attn"]["qkv"], H, 1e-6, True)
    else:
        scores = jnp.asarray(prev)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(select_tokens_dense(scores, keep)[0]))
    np.testing.assert_allclose(got_ns.numpy(), np.asarray(want_ns), atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **ACT)


@pytest.mark.parametrize("with_ls", [False, True])
def test_b8_attn_mlp_block_matches_pallas(rng, with_ls):
    jb, tb = _block(rng, 64, 256, with_ls)
    x = rng.standard_normal((B, N, 64)).astype(np.float32)
    want = jblock.fused_attn_mlp_block(jnp.asarray(x), jb, H, SCALE)
    got = twb.fused_attn_mlp_block(torch.from_numpy(x), tb, H, SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_b7_b8_equal_split_kernels_in_bf16(rng):
    """The design's premise, checked on the reference: in bf16 the JAX
    whole-block kernels equal K1/K2 then K3, the residual stream rounded to
    bf16 between the halves (block.py:2016-2017, 2207-2209). The port's B7
    and B8 are that composition."""
    from rajni_tpu.kernels import mlp as jmlp

    jb, _ = _block(rng, 64, 256, True)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jb)
    x = jnp.asarray(rng.standard_normal((B, N, 64)), jnp.bfloat16)
    mid = jblock.fused_attn_block(x, jb["norm1"], jb["attn"], jb["ls1"], H, SCALE)
    split = jmlp.fused_ln_mlp_residual(mid, jb["norm2"], jb["mlp"], jb["ls2"])
    np.testing.assert_array_equal(np.asarray(jblock.fused_attn_mlp_block(x, jb, H, SCALE), np.float32),
                                  np.asarray(split, np.float32))
    mid, _ = jblock.fused_pruned_attn_block(x, jb["norm1"], jb["attn"], jb["ls1"], None, H, 17,
                                            SCALE)
    split = jmlp.fused_ln_mlp_residual(mid, jb["norm2"], jb["mlp"], jb["ls2"])
    whole, _ = jblock.fused_pruned_block_full(x, jb, None, H, 17, SCALE)
    np.testing.assert_array_equal(np.asarray(whole, np.float32), np.asarray(split, np.float32))


# ---------------------------------------------------------------------------
# B14, B15 (int8 whole blocks)
# ---------------------------------------------------------------------------


def _force_hc(monkeypatch, kernel_j, plan_fn_j, plan_fn_t, args, want_hc):
    """Patch both packages' VMEM budget to one where the plan's hc is
    ``want_hc`` (the JAX fit rule decides hc; both sides must agree). The
    JAX kernel reads the budget when it traces, so its jit cache is
    cleared first."""
    kernel_j.clear_cache()
    if plan_fn_j(*args)[1] == want_hc:
        return
    for budget in range(0, 16 << 20, 4096):
        monkeypatch.setattr(jblock, "_VMEM_BUDGET", budget)
        plan = plan_fn_j(*args)
        if plan is not None and plan[1] == want_hc:
            monkeypatch.setattr(twb, "_VMEM_BUDGET", budget)
            assert plan_fn_t(*args) == plan
            return
    raise AssertionError(f"no budget gives hc={want_hc}")


@pytest.mark.parametrize("hc_part", [1, 2], ids=["hc=hidden", "hc=hidden/2"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_b14_pruned_block_full_int8_matches_pallas(rng, monkeypatch, static, hc_part):
    C, hidden, keep = 64, 256, 19
    _force_hc(monkeypatch, jblock.fused_pruned_block_full_int8, jblock._pruned_full_int8_plan,
              twb._pruned_full_int8_plan,
              (N, keep + 1, C, hidden, 4), hidden // hc_part)
    jb, tb = _block(rng, C, hidden, with_ls=static, int8=True)  # qkv/proj biases non-zero
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    scales = STATIC if static else None
    jx = jnp.asarray(x)
    want_x, want_ns = jblock.fused_pruned_block_full_int8(jx, jb, None, H, keep, SCALE, 1e-6, True,
                                                          act_scales=scales)
    got_x, got_ns, got_idx = twb.fused_pruned_block_full_int8(
        torch.from_numpy(x), tb, None, H, keep, SCALE, 1e-6, True, scales)
    # the kept tokens: the JAX next_scores are the port's own scores at the
    # port's kept indices, in the same order
    np.testing.assert_allclose(got_ns.numpy(), np.asarray(want_ns), atol=1e-6)
    _int8_close(got_x.numpy(), want_x, "B14")
    if hc_part == 1:
        return
    # threaded scores: the selection is fixed by prev_scores
    prev = rng.random((B, N)).astype(np.float32)
    want_x, want_ns = jblock.fused_pruned_block_full_int8(jx, jb, jnp.asarray(prev), H, keep,
                                                          SCALE, 1e-6, False, act_scales=scales)
    got_x, got_ns, got_idx = twb.fused_pruned_block_full_int8(
        torch.from_numpy(x), tb, torch.from_numpy(prev), H, keep, SCALE, 1e-6, False, scales)
    np.testing.assert_array_equal(got_idx.numpy(),
                                  np.asarray(select_tokens_dense(jnp.asarray(prev), keep)[0]))
    np.testing.assert_array_equal(got_ns.numpy(), np.asarray(want_ns))
    _int8_close(got_x.numpy(), want_x, "B14 threaded")


@pytest.mark.parametrize("hc_part", [1, 2], ids=["hc=hidden", "hc=hidden/2"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_b15_block_full_int8_matches_pallas(rng, monkeypatch, static, hc_part):
    C, hidden = 64, 256
    _force_hc(monkeypatch, jblock.fused_block_full_int8, jblock._block_full_int8_plan,
              twb._block_full_int8_plan,
              (N, C, hidden, 4), hidden // hc_part)
    jb, tb = _block(rng, C, hidden, with_ls=not static, int8=True)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    scales = STATIC if static else None
    want = jblock.fused_block_full_int8(jnp.asarray(x), jb, H, SCALE, 1e-6, act_scales=scales)
    got = twb.fused_block_full_int8(torch.from_numpy(x), tb, H, SCALE, 1e-6, scales)
    _int8_close(got.numpy(), want, "B15")


def test_static_v_fold_reaches_the_bias(rng, monkeypatch):
    """Leaving the 1/a_proj fold out of the qkv bias (the fault
    tests/test_quant.py:459 guards) moves B15's output far past the int8
    tolerance: the test above would catch it."""
    jb, tb = _block(rng, 64, 256, int8=True)
    x = torch.from_numpy(rng.standard_normal((B, N, 64)).astype(np.float32))
    good = twb.fused_block_full_int8(x, tb, H, SCALE, 1e-6, STATIC)
    sound = twb.fold_static_attn

    def no_bias_fold(lns, lnb, sqkv, sproj, bqkv, aq, ap):
        out = sound(lns, lnb, sqkv, sproj, bqkv, aq, ap)
        return (*out[:4], bqkv.float())

    monkeypatch.setattr(twb, "fold_static_attn", no_bias_fold)
    bad = twb.fused_block_full_int8(x, tb, H, SCALE, 1e-6, STATIC)
    assert (bad - good).abs().max() > 5 * INT8_FLIP


# ---------------------------------------------------------------------------
# Calibration, routes and the forward
# ---------------------------------------------------------------------------

CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=3, num_heads=2, num_classes=10)
SCHED = {1: {"keep_ratio": 0.6, "update": True}}


def _setup(rng):
    jcfg, tcfg = jvit.ViTConfig(**CFG), tvit.ViTConfig(**CFG)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return jcfg, tcfg, _np_params(rng, CFG), images


def test_calibrate_act_scales_matches_jax(rng):
    jcfg, tcfg, jp, images = _setup(rng)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    want = jquant.calibrate_act_scales(jax.tree.map(jnp.asarray, jp), jnp.asarray(images), jcfg,
                                       jsched)
    tp = params_from_numpy(jp)
    got = tquant.calibrate_act_scales(tp, torch.from_numpy(images), tcfg, SCHED)
    np.testing.assert_allclose(np.array(got.blocks), np.array(want.blocks), rtol=1e-5)
    np.testing.assert_allclose(got.head, want.head, rtol=1e-5)
    # the calibration forward is the ops-path forward
    _, _, logits = tquant._calibration_forward(tp, torch.from_numpy(images), tcfg, SCHED)
    np.testing.assert_allclose(logits.numpy(),
                               tvit.vit_forward(tp, torch.from_numpy(images), tcfg, SCHED).numpy(),
                               **ACT)


def _spy(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            calls.append((_name, out[1] if isinstance(out, tuple) else None))
            return out

        monkeypatch.setattr(module, name, spy)


WHOLE = ("fused_pruned_block_full", "fused_attn_mlp_block", "fused_pruned_block_full_int8",
         "fused_block_full_int8")


@pytest.mark.parametrize("mode", ["bf16 kernels", "int8 dynamic", "int8 static"])
def test_narrow_forward_matches_jax(rng, monkeypatch, mode):
    """C=128, 2 heads (head_dim 64), depth 3, block 1 pruned: ``impl="torch"``
    against JAX ``"xla"`` and ``impl="cuda"`` (plain versions) against JAX
    ``"pallas"``; the whole-block routes taken where JAX takes them."""
    jcfg, tcfg, jp, images = _setup(rng)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    scales = None
    if mode != "bf16 kernels":
        if mode == "int8 static":
            scales = jquant.calibrate_act_scales(jax.tree.map(jnp.asarray, jp), jnp.asarray(images),
                                                 jcfg, jsched)
        jp = jax.tree.map(np.asarray, _jquantize(jax.tree.map(jnp.asarray, jp)))
    tscales = None if scales is None else tquant.ActScales(scales.blocks, scales.head)
    jparams, tp, x = jax.tree.map(jnp.asarray, jp), params_from_numpy(jp), torch.from_numpy(images)
    jsel, tsel_torch, tsel_cuda = {}, {}, {}

    def jtap(i, k):
        jax.debug.callback(lambda kk: jsel.__setitem__(i, np.asarray(kk)), k)

    want_xla = jax.jit(lambda p, im: jvit.vit_forward(p, im, jcfg, jsched, "xla", scales,
                                                      _sel_tap=jtap))(jparams, jnp.asarray(images))
    want_xla.block_until_ready()
    jcalls, tcalls = [], []
    _spy(monkeypatch, jblock, WHOLE, jcalls)
    want = jvit.vit_forward(jparams, jnp.asarray(images), jcfg, jsched, "pallas", scales)
    _spy(monkeypatch, tvit, WHOLE, tcalls)
    got_torch = tvit.vit_forward(tp, x, tcfg, SCHED, "torch", tscales,
                                 _sel_tap=lambda i, k: tsel_torch.__setitem__(i, k.numpy()))
    got = tvit.vit_forward(tp, x, tcfg, SCHED, "cuda", tscales,
                           _sel_tap=lambda i, k: tsel_cuda.__setitem__(i, k.numpy()))
    np.testing.assert_allclose(got_torch.numpy(), np.asarray(want_xla), **ACT)
    np.testing.assert_array_equal(tsel_torch[1], jsel[1])
    if mode == "bf16 kernels":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
        np.testing.assert_array_equal(tsel_cuda[1], jsel[1])
    else:
        _int8_close(got.numpy(), want, mode)
    # routes: B8, B7, B8 (bf16) or B15, B14, B15 (int8), as JAX
    prefix = "" if mode == "bf16 kernels" else "_int8"
    stock = "fused_attn_mlp_block" if mode == "bf16 kernels" else "fused_block_full_int8"
    route = [stock, "fused_pruned_block_full" + prefix, stock]
    assert [c[0] for c in jcalls] == route
    assert [c[0] for c in tcalls] == route
    # the pruned block kept the same tokens: the JAX kernel's next_scores
    # are the port's scores at the port's kept indices
    np.testing.assert_allclose(tcalls[1][1].numpy(), np.asarray(jcalls[1][1]), atol=1e-6)
    assert sorted(tsel_cuda) == [1]


def test_quantized_routes_without_a_plan_raise(rng, monkeypatch):
    """The int8 routes without a whole-block plan run the split kernels and
    raise nowhere: where the JAX route is B11 (a pruned block whose
    one-kernel attention half fits), the cuda route takes B11 and then B9,
    never B12 and a tail."""
    _, tcfg, jp, images = _setup(rng)
    tp = params_from_numpy(jp)
    x = torch.from_numpy(images)
    mlp_only = tquant.quantize_params(tp, attn=False)
    q = tquant.quantize_params(tp)
    sched = {0: {"keep_ratio": 0.5}}
    monkeypatch.setattr(tvit, "_block_full_int8_plan", lambda *a: None)
    for params in (mlp_only, q):  # K1/K2 or B10, with B9
        assert torch.isfinite(tvit.vit_forward(params, x, tcfg, None, "cuda")).all()
    monkeypatch.setattr(tvit, "_pruned_full_int8_plan", lambda *a: None)
    calls = []
    _spy(monkeypatch, tvit, ("fused_pruned_attn_block_int8", "fused_ln_qkv_int8",
                             "fused_attn_block_int8", "fused_ln_mlp_residual_int8"), calls)
    assert torch.isfinite(tvit.vit_forward(q, x, tcfg, sched, "cuda")).all()
    mlp = "fused_ln_mlp_residual_int8"
    assert [c[0] for c in calls] == ["fused_pruned_attn_block_int8", mlp,
                                     "fused_attn_block_int8", mlp, "fused_attn_block_int8", mlp]
    # the ops path runs them (dequantized), as JAX's "xla" route does
    assert torch.isfinite(tvit.vit_forward(mlp_only, x, tcfg, SCHED, "torch")).all()
    assert torch.isfinite(tvit.vit_forward(q, x, tcfg, sched, "torch")).all()


def test_whole_block_wrappers_refuse_other_devices(rng):
    _, tb = _block(rng, 64, 256)
    _, qb = _block(rng, 64, 256, int8=True)
    x = torch.empty(B, N, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        twb.fused_pruned_block_full(x, tb, None, H, 5, SCALE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        twb.fused_attn_mlp_block(x, tb, H, SCALE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        twb.fused_pruned_block_full_int8(x, qb, None, H, 5, SCALE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        twb.fused_block_full_int8(x, qb, H, SCALE)


def test_eval_cli_quantize_calibrate_on_cpu(tmp_path):
    import json

    from rajni_tpu_torch import run

    sched = tmp_path / "schedule.json"
    sched.write_text(json.dumps({str(k): v for k, v in REFERENCE_SCHEDULE.items()}))
    scales = tmp_path / "scales.json"
    cmd = [sys.executable, "-m", "rajni_tpu_torch.run", "--device", "cpu", "--synthetic", "2",
           "--batch_size", "2", "--model", "deit_small_patch16_64", "--schedule", str(sched),
           "--kernels", "cuda", "--warmup", "1", "--quantize", "--calibrate", "1",
           "--save_scales", str(scales)]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "Captured 1 calibration batches" in p.stdout and "RAJNI - Accuracy:" in p.stdout
    assert len(tquant.ActScales.load(str(scales)).blocks) == 12
    for bad, msg in ((["--calibrate", "1"], "requires --quantize"),
                     (["--quantize", "--calibrate", "1", "--load_scales", "f"], "exclusive"),
                     (["--load_scales", "f"], "requires --quantize"),
                     (["--quantize", "--save_scales", "f"], "--calibrate")):
        with pytest.raises(ValueError, match=msg):
            run._check_quant_args(run.get_args(["--synthetic", "1", *bad]))
