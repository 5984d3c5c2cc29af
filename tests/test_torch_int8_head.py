"""The int8 heads' operands and the two-kernel route's selection against the
JAX package: the static operands folded once, when the scales are attached
(``kernels/block.py:attach_attn_operands``, ``quant.attach_act_scales``,
``RAJNIViT``; read by B10-B13), the selection wrapper
(``kernels/block.py:select_kept``, ``csrc/select.cu`` on the card) against
``select_tokens_dense`` of both packages, the refusals of the row-band
GEMM's proj (``kernels/gemm.py:band_proj``), and a
narrow int8 forward past 256 tokens through the two-kernel route (B12, the
selection, B13).

On the CPU the wrappers run their plain versions; the JAX kernels run in
interpret mode. Inputs come from numpy. Folded operands and selections are
held bit for bit; the forward with
tests/test_torch_wholeblock.py's int8 tolerance (``_int8_close``), its kept
indices exactly.
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
from rajni_tpu.models import vit as jvit
from rajni_tpu.ops.pruning import select_tokens_dense as jselect
from rajni_tpu_torch import params_from_numpy, quant as tquant
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import gemm as tgemm
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.models import wrapper as tvit_wrapper
from rajni_tpu_torch.ops.pruning import select_tokens_dense as tselect
from tests.test_torch_wholeblock import (INT8_FLIP, _block, _int8_close, _jquantize,
                                         _np_params)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SCALES = (3 / 127, 2 / 127)  # (a_qkv, a_proj)
OTHER = (5 / 127, 7 / 127)


def _layer(C: int, seed: int = 0):
    """One int8 block of width C in the port's layout (JAX int8 records)."""
    return _block(np.random.default_rng(seed), C, 4 * C, with_ls=True, int8=True)[1]


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


# ---------------------------------------------------------------------------
# (a), (b): the static operands, folded once when the scales are attached
# ---------------------------------------------------------------------------


def _fold_spy(monkeypatch) -> list:
    """Record the scales of each fold in ``kernels/block.py``:
    ``fold_static_attn``'s, and ``_int8_proj_operands``' with a static
    ``a_proj``."""
    calls = []
    for name in ("fold_static_attn", "_int8_proj_operands"):
        sound = getattr(tblock, name)

        def spy(*a, _sound=sound):
            if a[-1] is not None:
                calls.append(a[-2:] if len(a) > 2 else a[-1:])
            return _sound(*a)

        monkeypatch.setattr(tblock, name, spy)
    return calls


def _read(kind: str, ln, attn, scales) -> dict:
    """The operands wrapper ``kind`` reads for ``scales``."""
    if kind == "B13":
        return tblock.proj_operands(attn["proj"], None if scales is None else scales[1])
    return tblock.attn_operands(ln, attn if kind == "B10/B11" else {"qkv": attn["qkv"]},
                                       scales)


def _fresh(kind: str, ln, attn, scales) -> dict:
    """The per-call fold of wrapper ``kind``'s operands."""
    if kind == "B13":
        return tblock._int8_proj_operands(attn["proj"], None if scales is None else scales[1])
    return tblock.int8_attn_operands(ln, attn if kind == "B10/B11" else {"qkv": attn["qkv"]},
                                     scales)


@pytest.mark.parametrize("kind", ["B10/B11", "B12", "B13"])
@pytest.mark.parametrize("C", [128, 384])
def test_attached_operands_equal_the_per_call_fold(monkeypatch, C, kind):
    """The operand set of each wrapper, attached once
    (``attach_attn_operands``), is bitwise the per-call fold
    (:func:`..math.fold_static_attn` inside ``int8_attn_operands``, B13's
    ``_int8_proj_operands``), its reads fold nothing, dynamic reads are the
    unfolded operands (read as attached where dynamic scales are attached),
    and the attention folds are JAX's ``fold_static_attn``'s bits."""
    blk = _layer(C)
    ln, attn = blk["norm1"], blk["attn"]
    attached = tblock.attach_attn_operands(ln, attn, SCALES)
    assert "attached" not in attn["qkv"] and "attached" not in attn["proj"]  # a new dict
    calls = _fold_spy(monkeypatch)
    got = _read(kind, ln, attached, SCALES)
    dyn = _read(kind, ln, attached, None)
    assert calls == []
    _equal(got, _fresh(kind, ln, attn, SCALES))
    _equal(dyn, _fresh(kind, ln, attn, None))
    # dynamic scales attached: their operands read as made, not made again
    dyn_attached = tblock.attach_attn_operands(ln, attn, None)
    again = _read(kind, ln, dyn_attached, None)
    _equal(again, _fresh(kind, ln, attn, None))
    record = dyn_attached["proj" if kind == "B13" else "qkv"]["attached"]
    assert all(again[k] is v for k, v in record.ops.items())
    assert _read(kind, ln, dyn_attached, SCALES)["sproj" if kind == "B13" else "ln1s"] is not (
        record.ops["sproj" if kind == "B13" else "ln1s"])  # static reads are not served by them
    if kind != "B13":
        sproj = attn["proj"]["weight"]["scale"] if kind == "B10/B11" else None
        want = jmath.fold_static_attn(
            *(jnp.asarray(t.float().numpy()[None]) if t is not None else None
              for t in (ln["scale"], ln["bias"], attn["qkv"]["weight"]["scale"], sproj,
                        attn["qkv"]["bias"])), *SCALES)
        for k, w in zip(("ln1s", "ln1b", "sqkv", "sproj", "bqkv"), want):
            if w is not None:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(w)[0])


@pytest.mark.parametrize("where", ["attach_attn_operands", "attach_act_scales", "RAJNIViT"])
def test_attaching_other_scales_folds_again(monkeypatch, where):
    """Attaching folds once; reading with the attached scales folds
    nothing; attaching other scales folds again and replaces every operand;
    a read with scales other than those attached folds on the call, so no
    operand is stale. At the params level (``quant.attach_act_scales``) and
    through ``RAJNIViT``, which attaches on construction and again when its
    ``act_scales`` or ``params`` are set."""
    blk = _layer(128, seed=1)
    params = {"blocks": [blk, blk]}
    rows = tquant.ActScales(blocks=(SCALES + (1.0, 1.0), OTHER + (1.0, 1.0)), head=1.0)
    other = tquant.ActScales(blocks=(OTHER + (1.0, 1.0), SCALES + (1.0, 1.0)), head=1.0)
    calls = _fold_spy(monkeypatch)
    model = None
    if where == "attach_attn_operands":
        attach = [lambda sc: tblock.attach_attn_operands(blk["norm1"], blk["attn"], sc)]
        scales = [(SCALES,), (OTHER,)]
    elif where == "attach_act_scales":
        attach = [lambda sc: tquant.attach_act_scales(params, sc)]
        scales = [(rows,), (other,)]
    else:
        cfg = tvit.ViTConfig(img_size=8, patch_size=4, embed_dim=128, depth=2, num_heads=2,
                             num_classes=10)
        model = tvit_wrapper.RAJNIViT(cfg, None, params={**tvit.init_params(
            torch.Generator().manual_seed(0), cfg, torch.float32, "cpu"), "blocks": [blk, blk]},
            dtype=torch.float32, kernels="torch", device="cpu", act_scales=rows)
        scales = [(rows,), (other,)]

    def layers(tree):
        """(ln, attn, scales) of each attached layer of the tree."""
        if where == "attach_attn_operands":
            return [(blk["norm1"], tree, None)]
        return [(b["norm1"], b["attn"], None) for b in tree["blocks"]]

    def attached(sc):
        if model is not None:
            return model._forward_params
        return attach[0](sc)

    for step, (sc,) in enumerate(scales):
        n0 = len(calls)
        if model is not None and step == 1:
            model.act_scales = sc
        tree = attached(sc)
        per_layer = [sc] if where == "attach_attn_operands" else [r[:2] for r in sc.blocks]
        assert len(calls) - n0 == 2 * len(per_layer) or (model is not None and step == 0)
        for (ln, attn, _), s in zip(layers(tree), per_layer):
            n1 = len(calls)
            for kind in ("B10/B11", "B12", "B13"):
                _equal(_read(kind, ln, attn, s), _fresh(kind, ln, blk["attn"], s))
            assert len(calls) - n1 == 3  # the reference folds only (B10/B11, B12, B13)
            stale = OTHER if s == SCALES else SCALES
            n2 = len(calls)
            _equal(_read("B10/B11", ln, attn, stale), _fresh("B10/B11", ln, blk["attn"], stale))
            assert len(calls) - n2 == 2  # not attached for these: folded on the call
    assert "attached" not in blk["attn"]["qkv"]  # the given params are unchanged
    if model is not None:
        n0 = len(calls)
        model.params = {**model.params}
        assert len(calls) - n0 == 4  # setting params attaches again: 2 layers, 2 folds each
        with pytest.raises(ValueError):
            tquant.attach_act_scales({"blocks": [blk]}, rows)


# ---------------------------------------------------------------------------
# (c), (d): the two-kernel route's selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [9, 325, 577])
def test_select_kept_matches_both_dense_selections(N):
    """Planted ties (runs of equal scores across the keep boundary, a tie
    with CLS's score) and CLS the lowest score, so only the forcing keeps
    it: kept indices and next_scores exactly JAX's and the port's
    ``select_tokens_dense``."""
    rng = np.random.default_rng(N)
    B, keep = 3, max(1, int(0.7 * (N - 1)))
    s = rng.random((B, N)).astype(np.float32)
    s[:, 0] = -1.0  # CLS: the lowest score
    order = np.argsort(-s[:, 1:], axis=1, kind="stable") + 1
    for b in range(B):  # a tie straddling the boundary, and one at the top
        edge = order[b, max(0, keep - 2):keep + 2]
        s[b, edge] = s[b, order[b, keep - 1]]
        s[b, order[b, :2]] = s[b, order[b, 0]]
    s[1, 3 % N] = s[1, 0]  # a patch tied with CLS
    got_idx, got_ns = tblock.select_kept(torch.from_numpy(s), keep)
    want_idx, _ = tselect(torch.from_numpy(s), keep, torch.bool)
    j_idx, _ = jselect(jnp.asarray(s), keep, jnp.float32)
    assert got_idx.dtype == torch.int64 and got_idx.shape == (B, keep + 1)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx.numpy())
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(j_idx))
    assert (got_idx[:, 0] == 0).all()
    np.testing.assert_array_equal(got_ns.numpy(), np.take_along_axis(s, got_idx.numpy(), 1))


@pytest.mark.parametrize("case", ["bf16 scores", "1-D scores", "3-D scores", "keep 0",
                                  "keep N", "one token"])
def test_select_kept_refuses(case):
    s = torch.rand(2, 9)
    keep = 4
    if case == "bf16 scores":
        s = s.bfloat16()
    elif case == "1-D scores":
        s = s[0]
    elif case == "3-D scores":
        s = s[None]
    elif case == "keep 0":
        keep = 0
    elif case == "keep N":
        keep = 9
    else:
        s = s[:, :1]
    with pytest.raises(ValueError):
        tblock.select_kept(s, keep)


# ---------------------------------------------------------------------------
# The row-band GEMM's proj: refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["C % 128", "C > 1280", "N % 128", "int8 A", "fp32 A",
                                  "without residual"])
def test_band_proj_refuses(case):
    """The band proj refuses, on the CPU too, what the kernel does not take;
    a shape it takes runs its plain version, gemm_s8q_plain."""
    C = {"C % 128": 192, "C > 1280": 1408}.get(case, 128)
    N = C + (16 if case == "N % 128" else 0)
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.standard_normal((4, C)).astype(np.float32)).bfloat16()
    if case == "int8 A":
        o = o.to(torch.int8)
    elif case == "fp32 A":
        o = o.float()
    w = torch.from_numpy(rng.integers(-127, 128, (N, C)).astype(np.int8))
    vec = torch.ones(N)
    res = torch.zeros(4, N, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tgemm.band_proj(o, None, w, vec, vec, res=None if case == "without residual" else res)
    ok = tgemm.band_proj(o[:, :128].contiguous().bfloat16(), None, w[:128, :128].contiguous(),
                         vec[:128], vec[:128], res=res[:, :128].contiguous())
    assert torch.equal(ok, tgemm.gemm_s8q_plain(o[:, :128].bfloat16(), None, w[:128, :128],
                                                vec[:128], vec[:128], res=res[:, :128]))


# ---------------------------------------------------------------------------
# (e): the narrow int8 two-kernel route past 256 tokens
# ---------------------------------------------------------------------------

# 72 / 4 = 18² patches + CLS = 325 tokens at C = 128 (head_dim 64): block 0
# rescores at 325 tokens and keeps 195, block 1 is stock
NARROW = dict(img_size=72, patch_size=4, embed_dim=128, depth=2, num_heads=2, num_classes=10)
NARROW_SCHED = {0: {"keep_ratio": 0.6, "update": True}}


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(7)
    jp = _np_params(rng, NARROW)
    images = rng.standard_normal((2, 72, 72, 3)).astype(np.float32)
    jq = jax.tree.map(np.asarray, _jquantize(jax.tree.map(jnp.asarray, jp)))
    return jp, jq, images


TWO_KERNEL = ("fused_ln_qkv_int8", "fused_gather_sdpa_proj_residual_int8")


def _capture(monkeypatch, module, out: dict) -> None:
    """Record each call's output of the two-kernel route's int8 kernels."""
    for name in TWO_KERNEL:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            res = _fn(*a, **kw)
            out[_name] = res
            return res

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_narrow_two_kernel_int8_route_matches_jax(narrow, monkeypatch, mode):
    """B12, the selection and B13 at 325 tokens (the whole-block plans and
    the one-kernel pruned half patched off in both packages, the int8 tail
    kept): ``impl="cuda"`` against JAX ``"pallas"``, B12's qkv and B13's
    output with ``_int8_close`` and the kept indices exactly, the logits
    within one quantizer step (``INT8_FLIP``: a flipped step in the CLS row
    moves all of its image's logits, so the share of elements off says
    nothing at 2 x 10 logits); ``impl="torch"`` against ``"xla"`` at the
    float tolerance. The port's selection goes through ``select_kept``,
    once."""
    jp, jq, images = narrow
    jcfg, tcfg = jvit.ViTConfig(**NARROW), tvit.ViTConfig(**NARROW)
    assert tcfg.num_tokens == 325
    jsched = jvit.normalize_schedule(NARROW_SCHED, jcfg.depth)
    x = torch.from_numpy(images)
    scales = tscales = None
    if mode == "static":
        tscales = tquant.calibrate_act_scales(params_from_numpy(jp), x, tcfg, NARROW_SCHED)
        scales = jquant.ActScales(tuple(map(tuple, tscales.blocks)), tscales.head)
    for mod, names in ((jblock, ("_full_block_fits_int8", "_block_full_int8_fits")),
                       (tvit, ("_pruned_full_int8_plan", "_block_full_int8_plan"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a: None)
        monkeypatch.setattr(mod, "_pruned_block_fits", lambda *a: False)
        monkeypatch.setattr(mod, "_gather_fits_fast", lambda *a: True)
    calls = []
    sound_select = tvit.select_kept
    monkeypatch.setattr(tvit, "select_kept",
                        lambda s, k: calls.append(tuple(s.shape)) or sound_select(s, k))
    sel = {k: {} for k in ("xla", "pallas", "torch", "cuda")}

    def tap(key):
        return lambda i, k: sel[key].__setitem__(i, np.asarray(k))

    jparams = jax.tree.map(jnp.asarray, jq)
    want = {"xla": jvit.vit_forward(jparams, jnp.asarray(images), jcfg, jsched, "xla", scales,
                                    _sel_tap=tap("xla"))}
    jout, tout = {}, {}
    _capture(monkeypatch, jblock, jout)
    _capture(monkeypatch, tvit, tout)
    want["pallas"] = jvit.vit_forward(jparams, jnp.asarray(images), jcfg, jsched, "pallas",
                                      scales, _sel_tap=tap("pallas"))
    tp = params_from_numpy(jq)
    got = {impl: tvit.vit_forward(tp, x, tcfg, NARROW_SCHED, impl, tscales, _sel_tap=tap(impl))
           for impl in ("torch", "cuda")}
    assert sorted(tout) == sorted(jout) == sorted(TWO_KERNEL)
    assert calls == [(2, 325)]
    for t, j in (("cuda", "pallas"), ("torch", "xla")):
        assert sorted(sel[t]) == sorted(sel[j]) == [0]
        np.testing.assert_array_equal(sel[t][0], sel[j][0])
    qkv, scores = tout["fused_ln_qkv_int8"]
    _int8_close(qkv.numpy(), np.asarray(jout["fused_ln_qkv_int8"][0]), f"{mode} B12 qkv")
    np.testing.assert_allclose(scores.numpy(), np.asarray(jout["fused_ln_qkv_int8"][1]),
                               atol=1e-6)
    _int8_close(tout["fused_gather_sdpa_proj_residual_int8"].numpy(),
                np.asarray(jout["fused_gather_sdpa_proj_residual_int8"]), f"{mode} B13")
    assert np.abs(got["cuda"].numpy() - np.asarray(want["pallas"])).max() <= INT8_FLIP
    np.testing.assert_allclose(got["torch"].numpy(), np.asarray(want["xla"]), rtol=1e-4,
                               atol=1e-5)
