"""The port's B11 ``fused_pruned_attn_block_int8``, B19
``fused_ln_qkv_select`` and B20 ``fused_pruned_attn_block_long`` against the
JAX package, the copied fit rules that route B11 on int8 ViT-L/16 224 and
DeiT-S/16 384, and a narrow int8 forward that takes B11 on both sides.

The conventions are tests/test_torch_int8_split.py's: the JAX kernels run in
interpret mode on the CPU and the port's wrappers take their plain versions
because the tensors lie on the CPU; inputs come from numpy with a seed; int8
records are the JAX ``quantize_weight``'s, carried across; rtol 1e-4 / atol
1e-5 with ``_int8_close``'s one-step flip allowance (derived in
tests/test_torch_wholeblock.py), atol 1e-6 on scores, kept indices exact.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import quant as jquant
from rajni_tpu.kernels import block as jblock
from rajni_tpu.kernels import longseq as jlong
from rajni_tpu.kernels import mlp as jmlp
from rajni_tpu.models import vit as jvit
from rajni_tpu.ops.pruning import select_tokens_dense as jselect
from rajni_tpu_torch import params_from_numpy, quant as tquant
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import longseq as tlong
from rajni_tpu_torch.kernels import mlp as tmlp
from rajni_tpu_torch.kernels import wholeblock as twb
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.params.from_jax import _dense, _norm
from tests.test_torch_int8_split import _bf16
from tests.test_torch_wholeblock import ACT, _int8_close, _jquantize, _np_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

C, B, N, H, KEEP = 128, 2, 29, 2, 19
SCALE = 64 ** -0.5
STATIC = (4 / 127, 2 / 127)  # (a_qkv, a_proj)


@pytest.fixture(scope="module")
def blk():
    """One int8 block's attention half (non-zero biases, layer scale) as JAX
    and port trees, its input and threaded scores."""
    rng = np.random.default_rng(17)
    jl, ja, tl, ta = _attn_params(rng, C, 1 / np.sqrt(C))
    for jd, td in ((ja["qkv"], ta["qkv"]), (ja["proj"], ta["proj"])):
        jd["kernel"] = jquant.quantize_weight(jd["kernel"])
        td["weight"] = _dense({"kernel": jax.tree.map(np.asarray, jd["kernel"]),
                               "bias": np.asarray(jd["bias"])})["weight"]
    ls = (0.5 * rng.standard_normal(C)).astype(np.float32)
    jb = {"norm1": jl, "attn": ja, "ls1": jnp.asarray(ls)}
    tb = {"norm1": tl, "attn": ta, "ls1": torch.from_numpy(ls)}
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    prev = rng.standard_normal((B, N)).astype(np.float32)
    return jb, tb, x, prev


def _attn_params(rng, C_, w_std=0.1):
    """An fp32 LayerNorm and attention half (weights ``w_std``·N(0, 1),
    biases 0.1·N(0, 1)) as JAX and port trees: ``(jax ln, jax attn, port
    ln, port attn)``."""
    ln = {"scale": (1 + 0.1 * rng.standard_normal(C_)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(C_)).astype(np.float32)}
    attn = {name: {"kernel": (rng.standard_normal((C_, w)) * w_std).astype(np.float32),
                   "bias": (rng.standard_normal(w) * 0.1).astype(np.float32)}
            for name, w in (("qkv", 3 * C_), ("proj", C_))}
    jl, ja = jax.tree.map(jnp.asarray, ln), jax.tree.map(jnp.asarray, attn)
    return jl, ja, _norm(ln), {k: _dense(v) for k, v in attn.items()}


# ---------------------------------------------------------------------------
# Fit rules: where B11 runs
# ---------------------------------------------------------------------------

# scripts/bench_suite.py:36 VIT_L_AGGRESSIVE and :33 DEIT_S_DYNAMIC
VIT_L_SCHED = {i: {"keep_ratio": 0.7} for i in (4, 8, 12, 16)}
DEIT_S_SCHED = {i: {"keep_ratio": 0.9, "update": True} for i in range(3, 11)}


def _routes(mod, trace, pruned, C_, hidden):
    """The int8 route of each block under ``mod``'s fit rules (bf16)."""
    full_plan = getattr(mod, "_pruned_full_int8_plan")
    out = []
    for i, n in enumerate(trace):
        if i in pruned:
            k = trace[i + 1]
            out.append("B14" if full_plan(n, k, C_, hidden, 2) else
                       "B11" if mod._pruned_block_fits(n, k, C_, 2) else "B12")
        else:
            out.append("B15" if mod._block_full_int8_plan(n, C_, hidden, 2) else "B10")
    return out


@pytest.mark.parametrize("model,sched,routes", [
    ("vit_large_patch16_224", VIT_L_SCHED,
     ["B10"] * 4 + ["B11"] + ["B10"] * 3 + ["B11"] + ["B10"] * 3 + ["B11"] + ["B15"] * 3
     + ["B11"] + ["B15"] * 7),
    ("deit_small_patch16_384", DEIT_S_SCHED, ["B15"] * 3 + ["B11"] + ["B14"] * 7 + ["B15"]),
], ids=["ViT-L/16-224", "DeiT-S/16-384"])
def test_b11_fit_rules_route_as_jax(model, sched, routes):
    tcfg, jcfg = tvit.get_config(model), jvit.get_config(model)
    trace = tvit.model_stats(tcfg, sched)["token_counts"]
    assert trace == jvit.model_stats(jcfg, jvit.normalize_schedule(sched, jcfg.depth))[
        "token_counts"]
    C_, hidden = tcfg.embed_dim, tcfg.mlp_hidden
    for n, k in set(zip(trace, trace[1:])):
        assert twb._pruned_block_fits(n, k, C_, 2) == jblock._pruned_block_fits(n, k, C_, 2)
        assert (twb._pruned_full_int8_plan(n, k, C_, hidden, 2)
                == jblock._pruned_full_int8_plan(n, k, C_, hidden, 2))
        assert (twb._block_full_int8_plan(n, C_, hidden, 2)
                == jblock._block_full_int8_plan(n, C_, hidden, 2))
    assert _routes(twb, trace, sched, C_, hidden) == routes
    assert _routes(jblock, trace, sched, C_, hidden) == routes
    assert tmlp._hidden_chunk(C_, hidden, 1) == jmlp._hidden_chunk(C_, hidden, 1)
    if model.startswith("vit_large"):  # B15's hc, and B9 unchunked
        assert twb._block_full_int8_plan(67, C_, hidden, 2) == (1, 2048)
        assert twb._block_full_int8_plan(47, C_, hidden, 2) == (1, 4096)
        assert tmlp._hidden_chunk(C_, hidden, 1) == hidden


# ---------------------------------------------------------------------------
# B11's plain version against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("static,with_scores", [(False, True), (False, False), (True, True),
                                                (True, False)],
                         ids=["dynamic-scored", "dynamic-threaded", "static-scored",
                              "static-threaded"])
def test_b11_pruned_attn_block_int8_matches_pallas(blk, static, with_scores):
    """Outputs and next_scores against JAX's B11; the kept indices against
    JAX's selection of the scores its B12 gives the same qkv (under static
    scales B12 folds V as B11 does), or of the threaded scores."""
    jb, tb, x, prev = blk
    scales = STATIC if static else None
    jprev = None if with_scores else jnp.asarray(prev)
    want, want_ns = jblock.fused_pruned_attn_block_int8(
        jnp.asarray(x), jb["norm1"], jb["attn"], jb["ls1"], jprev, H, KEEP, SCALE, 1e-6,
        with_scores, act_scales=scales)
    got, ns, idx = tblock.fused_pruned_attn_block_int8(
        torch.from_numpy(x), tb["norm1"], tb["attn"], tb["ls1"],
        None if with_scores else torch.from_numpy(prev), H, KEEP, SCALE, 1e-6, with_scores,
        scales)
    if with_scores:
        s = jblock.fused_ln_qkv_int8(jnp.asarray(x), jb["norm1"], jb["attn"]["qkv"], H, 1e-6,
                                     True, act_scales=scales)[1]
    else:
        s = jnp.asarray(prev)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jselect(s, KEEP, jnp.float32)[0]))
    _int8_close(got.numpy(), want, f"B11 static={static} with_scores={with_scores}")
    np.testing.assert_allclose(ns.numpy(), np.asarray(want_ns), atol=1e-6)


def test_b11_rounds_its_attention_output_in_bf16(blk, monkeypatch):
    """In bf16 the TPU kernel rounds its attention output to bf16 before it
    quantizes it (``block.py:2566``); the port's plain version does the same,
    and the same plain version with an fp32 attention output (one function
    in fp32) moves far more outputs than the flip allowance. Threaded
    scores, so that both sides keep the same tokens."""
    jb, tb, x, prev = blk
    jb, tb = _bf16(jb), tvit.tree_to(tb, dtype=torch.bfloat16)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jblock.fused_pruned_attn_block_int8(
        jx, jb["norm1"], jb["attn"], jb["ls1"], jnp.asarray(prev), H, KEEP, SCALE, 1e-6,
        False)[0], np.float32)
    args = (tx, tb["norm1"], tb["attn"], tb["ls1"], torch.from_numpy(prev), H, KEEP, SCALE, 1e-6,
            False)
    _int8_close(tblock.fused_pruned_attn_block_int8(*args)[0].float().numpy(), want, "B11 bf16")
    sound = tblock._mha
    monkeypatch.setattr(tblock, "_mha", lambda q, h, s, dt: sound(q, h, s, torch.float32))
    bad = tblock.pruned_attn_block_int8_plain(*args)[0].float().numpy()
    assert (~np.isclose(bad, want, **ACT)).mean() > 0.1


# ---------------------------------------------------------------------------
# A narrow int8 forward through B11
# ---------------------------------------------------------------------------

# C=128, 2 heads, depth 3: block 0 rescoring at 17 tokens, block 1 threading
# its scores at 12, block 2 stock at 9. At ViT-L the whole-block plans fail
# because a block's int8 weights do not fit the TPU's VMEM budget while the
# attention half does; here the same happens under a smaller budget, set in
# both packages: at hidden 8·C the pruned attention halves need 354,384
# bytes (fp32) and the whole-block plans at least 381,568, so under
# BUDGET the JAX fit rules themselves send the pruned blocks to B11 + B9
# and the stock one to B10 + B9. B9's hidden chunk is left as it was (the
# MLP's own budget, hc = hidden).
CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=3, num_heads=2, num_classes=10,
           mlp_ratio=8.0)
SCHED = {0: {"keep_ratio": 0.7, "update": True}, 1: {"keep_ratio": 0.8, "update": False}}
BUDGET = 360 * 1024
INT8 = ("fused_pruned_attn_block_int8", "fused_ln_qkv_int8", "fused_attn_block_int8",
        "fused_pruned_block_full_int8", "fused_block_full_int8")
MLP8 = "fused_ln_mlp_residual_int8"


def _spy_io(monkeypatch, module, names, calls):
    """Record each call's name, outputs and the ``act_scales`` it was given."""
    for name in names:
        fn = getattr(module, name)
        sig = inspect.signature(fn)

        def spy(*a, _fn=fn, _name=name, _sig=sig, **kw):
            out = _fn(*a, **kw)
            act = _sig.bind(*a, **kw).arguments.get("act_scales")
            calls.append((_name, out, None if act is None else tuple(map(float, act))))
            return out

        monkeypatch.setattr(module, name, spy)


@pytest.fixture(scope="module")
def narrow():
    """The narrow model's parameters: unquantized (numpy, JAX layout), and
    quantized as JAX arrays and as the port's tree; and the images."""
    rng = np.random.default_rng(5)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jp = _np_params(rng, CFG)
    hidden = int(CFG["embed_dim"] * CFG["mlp_ratio"])
    for b in jp["blocks"]:
        for name, (fi, fo) in (("fc1", (C, hidden)), ("fc2", (hidden, C))):
            b["mlp"][name] = {
                "kernel": (rng.standard_normal((fi, fo)) / np.sqrt(fi)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(fo)).astype(np.float32)}
    jq = _jquantize(jax.tree.map(jnp.asarray, jp))
    return jp, jq, params_from_numpy(jax.tree.map(np.asarray, jq)), images


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_narrow_int8_forward_through_b11_matches_jax(narrow, monkeypatch, static):
    """``impl="cuda"`` (plain versions) against JAX ``"pallas"``, routed by
    the fit rules under BUDGET: B11 + B9 twice, then B10 + B9, on both sides.
    JAX's one-kernel route taps no selection, so each B11 is held by its
    outputs and next_scores, each kernel by the static scales it was given
    (B11 ``blk_as[:2]``, B9 ``blk_as[2:4]``, as ``rajni_tpu/models/vit.py``
    passes them), and the forward by its logits. Static scales are the
    port's calibration on these images, given to both."""
    jp, jq, tq, images = narrow
    jcfg, tcfg = jvit.ViTConfig(**CFG), tvit.ViTConfig(**CFG)
    monkeypatch.setattr(jblock, "_VMEM_BUDGET", BUDGET)
    monkeypatch.setattr(twb, "_VMEM_BUDGET", BUDGET)
    x = torch.from_numpy(images)
    scales = tscales = None
    if static:
        tscales = tquant.calibrate_act_scales(params_from_numpy(jp), x, tcfg, SCHED)
        scales = jquant.ActScales(tuple(map(tuple, tscales.blocks)), tscales.head)
    jcalls, tcalls = [], []
    _spy_io(monkeypatch, jblock, INT8, jcalls)
    _spy_io(monkeypatch, jmlp, (MLP8,), jcalls)
    _spy_io(monkeypatch, tvit, INT8 + (MLP8,), tcalls)
    want = jvit.vit_forward(jq, jnp.asarray(images), jcfg,
                            jvit.normalize_schedule(SCHED, jcfg.depth), "pallas", scales)
    got = tvit.vit_forward(tq, x, tcfg, SCHED, "cuda", tscales)
    route = ["fused_pruned_attn_block_int8", MLP8] * 2 + ["fused_attn_block_int8", MLP8]
    assert [c[0] for c in jcalls] == route
    assert [c[0] for c in tcalls] == route
    for i, ((_, jout, jas), (_, tout, tas)) in enumerate(zip(jcalls, tcalls)):
        if static:
            blk = scales.blocks[i // 2]
            assert tas == jas == tuple(map(float, blk[:2] if i % 2 == 0 else blk[2:4])), i
        else:
            assert tas is None and jas is None, i
        if i in (0, 2):  # B11: x [B, K, C] and next_scores
            _int8_close(tout[0].numpy(), jout[0], f"B11 of block {i // 2} static={static}")
            np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-6)
    _int8_close(got.numpy(), want, f"logits static={static}")


# ---------------------------------------------------------------------------
# B19 and B20: the tested alternatives no route takes
# ---------------------------------------------------------------------------




def test_b19_ln_qkv_select_matches_pallas():
    """The JAX test's geometry (``tests/test_kernels.py:118``): qkv, the
    one-hot, the kept indices and next_scores."""
    rng = np.random.default_rng(19)
    B_, N_, C_, H_, keep = 2, 57, 32, 4, 23
    jl, ja, tl, ta = _attn_params(rng, C_)
    x = rng.standard_normal((B_, N_, C_)).astype(np.float32)
    want = jblock.fused_ln_qkv_select(jnp.asarray(x), jl, ja["qkv"], H_, keep)
    qkv, sel, idx, ns = tblock.fused_ln_qkv_select(torch.from_numpy(x), tl, ta["qkv"], H_, keep)
    np.testing.assert_allclose(qkv.numpy(), np.asarray(want[0]), **ACT)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want[1]))
    assert idx.dtype == torch.int32 and sel.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(ns.numpy(), np.asarray(want[3]), atol=1e-6)


@pytest.mark.parametrize("with_scores", [True, False], ids=["scored", "threaded"])
def test_b20_pruned_attn_block_long_matches_pallas(with_scores):
    """The JAX test's ragged geometry (``tests/test_kernels.py:336``): N=300,
    K=277, three 128-row query chunks on the TPU, the last partial."""
    rng = np.random.default_rng(20)
    B_, N_, C_, H_, keep = 2, 300, 32, 4, 276
    jl, ja, tl, ta = _attn_params(rng, C_)
    x = rng.standard_normal((B_, N_, C_)).astype(np.float32)
    prev = rng.standard_normal((B_, N_)).astype(np.float32)
    scale = 8 ** -0.5
    want, want_ns = jlong.fused_pruned_attn_block_long(
        jnp.asarray(x), jl, ja, None, None if with_scores else jnp.asarray(prev), H_, keep,
        scale, 1e-6, with_scores)
    got, ns, idx = tlong.fused_pruned_attn_block_long(
        torch.from_numpy(x), tl, ta, None, None if with_scores else torch.from_numpy(prev), H_,
        keep, scale, 1e-6, with_scores)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    np.testing.assert_allclose(ns.numpy(), np.asarray(want_ns), atol=1e-6)
    assert idx.shape == (B_, keep + 1)
    fits = ((577, 548, 768), (300, 277, 32), (577, 548, 1024))
    assert ([tlong.longseq_block_fits(n, k, c, 2) for n, k, c in fits]
            == [jlong.longseq_block_fits(n, k, c, 2) for n, k, c in fits])


def test_new_wrappers_refuse_other_devices(blk):
    _, tb, _, _ = blk
    x = torch.empty(B, N, C, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblock.fused_pruned_attn_block_int8(x, tb["norm1"], tb["attn"], None, None, H, KEEP,
                                            SCALE)
    rng = np.random.default_rng(0)
    _, _, tl, ta = _attn_params(rng, C)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblock.fused_ln_qkv_select(x, tl, ta["qkv"], H, KEEP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlong.fused_pruned_attn_block_long(x, tl, ta, None, None, H, KEEP, SCALE)
