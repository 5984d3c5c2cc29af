"""The port's long-sequence slice (ViT-B/384, N = 577) against the JAX package.

B6 ``fused_sdpa``, B4 ``fused_ln_qkv``, B5 ``fused_gather_sdpa_proj_residual``
and K2 past 256 tokens: their plain versions (which the wrappers run on CPU
tensors) against the JAX Pallas kernels in interpret mode, as
tests/test_kernels.py runs them, with the JAX fit rules patched where a body
or route must be forced. Then a narrow ViT with N > 256 end to end. All in
fp32 on the CPU, inputs from numpy. Tolerances follow tests/test_kernels.py:
rtol 1e-4 / atol 1e-5 for activations and logits, atol 1e-6 for scores;
selections and token counts exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.kernels import attention as jsdpa
from rajni_tpu.kernels import block as jblock
from rajni_tpu.models import vit as jvit
from rajni_tpu.ops import attention as jattn
from rajni_tpu.ops import pruning as jprune
from rajni_tpu_torch import REFERENCE_SCHEDULE, params_from_numpy
from rajni_tpu_torch.kernels import attention as tsdpa
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.models import vit as tvit
from rajni_tpu_torch.ops import attention as tattn
from rajni_tpu_torch.ops import pruning as tprune


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ACT = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _attn_block(rng, C: int, with_ls: bool = False):
    """Random LN1 + attention params (+ ls1) as a JAX tree and as the
    port's tree."""
    def dense(fi, fo):
        return {"kernel": rng.standard_normal((fi, fo)).astype(np.float32) / np.sqrt(fi),
                "bias": rng.standard_normal(fo).astype(np.float32) * 0.1}

    jb = {"norm1": {"scale": 1 + 0.1 * rng.standard_normal(C).astype(np.float32),
                    "bias": 0.1 * rng.standard_normal(C).astype(np.float32)},
          "attn": {"qkv": dense(C, 3 * C), "proj": dense(C, C)}}
    if with_ls:
        jb["ls1"] = (0.5 * rng.standard_normal(C)).astype(np.float32)

    def conv(d):
        if isinstance(d, dict):
            if "kernel" in d:
                return {"weight": _t(d["kernel"].T.copy()), "bias": _t(d["bias"])}
            return {k: conv(v) for k, v in d.items()}
        return _t(d)

    return jax.tree.map(jnp.asarray, jb), conv(jb)


# ---------------------------------------------------------------------------
# B6 fused_sdpa
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,H,D", [(1, 577, 4, 16), (2, 197, 4, 16)])
def test_b6_fused_sdpa_matches_pallas(rng, B, N, H, D):
    qkv = rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)
    want = jsdpa.fused_sdpa(jnp.asarray(qkv), H, D**-0.5)
    got = tsdpa.fused_sdpa(_t(qkv), H, D**-0.5)
    assert got.shape == (B, N, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_b6_fused_sdpa_4d_layout(rng):
    """The head-aligned ``[B, N, 3, C]`` layout has the packed element order."""
    B, N, H, D = 2, 33, 4, 16
    qkv = rng.standard_normal((B, N, 3, H * D)).astype(np.float32)
    want = jsdpa.fused_sdpa(jnp.asarray(qkv), H, D**-0.5)
    got = tsdpa.fused_sdpa(_t(qkv), H, D**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    flat = tsdpa.fused_sdpa(_t(qkv.reshape(B, N, -1)), H, D**-0.5)
    np.testing.assert_array_equal(got.numpy(), flat.numpy())


def test_mha_takes_the_perhead_form_past_4mib(rng, monkeypatch):
    """Where ``H·N²·6 > 4 MiB`` the JAX ``_mha`` switches to the per-head form
    (scale on the fp32 logits); with a head_dim that is not a power of two the
    two forms differ, and the plain K2 must take the per-head one."""
    B, N, H, D = 1, 300, 8, 12
    C = H * D
    assert H * N * N * 6 > 4 * 1024 * 1024
    jb, tb = _attn_block(rng, C)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    calls = []
    perhead = tblock._sdpa_perhead
    monkeypatch.setattr(tblock, "_sdpa_perhead", lambda *a: calls.append(1) or perhead(*a))
    want = jblock.fused_attn_block(jnp.asarray(x), jb["norm1"], jb["attn"], None, H, D**-0.5)
    got = tblock.fused_attn_block(_t(x), tb["norm1"], tb["attn"], None, H, D**-0.5)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)

    qkv, _ = tblock.ln_qkv_plain(_t(x), tb["norm1"], tb["attn"]["qkv"], H, 1e-6, False)
    want = jsdpa.fused_sdpa(jnp.asarray(qkv.numpy()), H, D**-0.5)
    np.testing.assert_allclose(tsdpa.fused_sdpa(qkv, H, D**-0.5).numpy(), np.asarray(want), **ACT)


# ---------------------------------------------------------------------------
# B4 fused_ln_qkv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_scores", [True, False])
def test_b4_ln_qkv_matches_pallas(rng, with_scores):
    B, N, C, H = 2, 300, 64, 4
    jb, tb = _attn_block(rng, C)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    jq, js = jblock.fused_ln_qkv(jnp.asarray(x), jb["norm1"], jb["attn"]["qkv"], H, 1e-6,
                                 with_scores)
    tq, ts = tblock.fused_ln_qkv(_t(x), tb["norm1"], tb["attn"]["qkv"], H, 1e-6, with_scores)
    assert tq.shape == (B, N, 3 * C) and ts.shape == (B, N) and ts.dtype == torch.float32
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **ACT)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    if not with_scores:
        assert not ts.any()


def test_b4_ln_qkv_on_a_tensor_parallel_shard(rng):
    """A head-aligned ``[C, 3C_local]`` shard (heads 0-1 of 4) projects
    without scores; asking for scores on it raises in both packages."""
    B, N, C, H = 2, 40, 64, 4
    jb, tb = _attn_block(rng, C)
    C_loc = C // 2
    cols = np.concatenate([np.arange(C_loc) + part * C for part in range(3)])
    jshard = {"kernel": jb["attn"]["qkv"]["kernel"][:, cols],
              "bias": jb["attn"]["qkv"]["bias"][cols]}
    tshard = {"weight": tb["attn"]["qkv"]["weight"][cols].contiguous(),
              "bias": tb["attn"]["qkv"]["bias"][cols].contiguous()}
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    jq, _ = jblock.fused_ln_qkv(jnp.asarray(x), jb["norm1"], jshard, H // 2, 1e-6, False)
    tq, ts = tblock.fused_ln_qkv(_t(x), tb["norm1"], tshard, H // 2, 1e-6, False)
    assert tq.shape == (B, N, 3 * C_loc)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **ACT)
    assert not ts.any()
    with pytest.raises(ValueError, match="shard"):
        jblock.fused_ln_qkv(jnp.asarray(x), jb["norm1"], jshard, H // 2, 1e-6, True)
    with pytest.raises(ValueError, match="shard"):
        tblock.fused_ln_qkv(_t(x), tb["norm1"], tshard, H // 2, 1e-6, True)


# ---------------------------------------------------------------------------
# B5 fused_gather_sdpa_proj_residual
# ---------------------------------------------------------------------------


def _selection(rng, B, N, keep):
    """The port's keep_idx and the JAX one-hot sel from the same scores,
    after checking that the two selections agree."""
    scores = rng.random((B, N)).astype(np.float32)
    t_idx, _ = tprune.select_tokens_dense(_t(scores), keep)
    j_idx, sel = jprune.select_tokens_dense(jnp.asarray(scores), keep, jnp.float32)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    return t_idx, sel


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("body", ["fast", "chunked"])
def test_b5_gather_sdpa_proj_residual_matches_pallas(rng, monkeypatch, body, with_ls):
    B, N, C, H, keep = 2, 300, 32, 4, 276  # K = 277: not a multiple of the 128-row chunk
    scale = (C // H) ** -0.5
    jb, tb = _attn_block(rng, C, with_ls)
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    t_idx, sel = _selection(rng, B, N, keep)
    fn = jblock.fused_gather_sdpa_proj_residual
    if body == "chunked":
        monkeypatch.setattr(jblock, "_VMEM_BUDGET", 1)  # force the query-chunked body
        fn = fn.__wrapped__  # bypass the jit cache of the fast trace
    else:
        assert jblock._gather_fits_fast(N, keep + 1, C, 4)
    want = fn(jnp.asarray(qkv), sel, jnp.asarray(x), jb["attn"]["proj"], jb.get("ls1"), H, scale)
    got = tblock.fused_gather_sdpa_proj_residual(
        _t(qkv), t_idx, _t(x), tb["attn"]["proj"], tb.get("ls1"), H, scale)
    assert got.shape == (B, keep + 1, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_b5_gather_tensor_parallel_partial_proj(rng):
    """A head shard ``qkv [B, N, 3C_local]`` with a row-parallel ``proj
    [C_local, C]`` gives that shard's partial proj plus the gathered residual."""
    B, N, C, H_loc, keep = 2, 40, 32, 2, 25
    C_loc = 16
    qkv = rng.standard_normal((B, N, 3 * C_loc)).astype(np.float32)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    wproj = rng.standard_normal((C_loc, C)).astype(np.float32) * 0.2
    bproj = rng.standard_normal(C).astype(np.float32) * 0.1
    t_idx, sel = _selection(rng, B, N, keep)
    want = jblock.fused_gather_sdpa_proj_residual(
        jnp.asarray(qkv), sel, jnp.asarray(x),
        {"kernel": jnp.asarray(wproj), "bias": jnp.asarray(bproj)}, None, H_loc, 8**-0.5)
    got = tblock.fused_gather_sdpa_proj_residual(
        _t(qkv), t_idx, _t(x), {"weight": _t(wproj.T.copy()), "bias": _t(bproj)}, None,
        H_loc, 8**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


# ---------------------------------------------------------------------------
# K2 past 256 tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_ls", [False, True])
def test_k2_attn_block_past_256_tokens_matches_pallas(rng, with_ls):
    B, N, C, H = 1, 300, 64, 4
    jb, tb = _attn_block(rng, C, with_ls)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    want = jblock.fused_attn_block(jnp.asarray(x), jb["norm1"], jb["attn"], jb.get("ls1"), H,
                                   (C // H) ** -0.5)
    got = tblock.fused_attn_block(_t(x), tb["norm1"], tb["attn"], tb.get("ls1"), H,
                                  (C // H) ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


# ---------------------------------------------------------------------------
# ops/attention.py impl="cuda"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("update", [True, False])
def test_ops_attention_cuda_impl_matches_pallas(rng, update):
    """``impl="cuda"`` reaches B6 (its plain version on the CPU), as JAX's
    ``impl="pallas"`` reaches ``fused_sdpa``."""
    B, N, C, H, keep = 2, 41, 32, 4, 20
    jb, tb = _attn_block(rng, C)
    scale = (C // H) ** -0.5
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    prev = rng.random((B, N)).astype(np.float32)
    want = jattn.attention(jnp.asarray(x), jb["attn"], H, scale, "pallas")
    got = tattn.attention(_t(x), tb["attn"], H, scale, "cuda")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    j_out, j_idx, j_ns = jattn.pruned_attention(
        jnp.asarray(x), jb["attn"], H, scale, keep, update, jnp.asarray(prev), "pallas")
    t_out, t_idx, t_ns = tattn.pruned_attention(
        _t(x), tb["attn"], H, scale, keep, update, _t(prev), "cuda")
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_ns.numpy(), np.asarray(j_ns), atol=1e-6)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **ACT)
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(_t(x), tb["attn"], H, scale, "pallas")


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

# 72 / 4 = 18² patches + CLS = 325 tokens. Block 1 rescoring at 325 tokens
# takes the two-kernel route (B4 + selection + B5); block 2 reuses the
# threaded scores at 195 tokens, where the port takes K1 and JAX (its
# whole-block and pruned-block fit rules patched off) the two-kernel route.
LONG_CFG = dict(img_size=72, patch_size=4, embed_dim=64, depth=3, num_heads=4, num_classes=10)
SHORT_CFG = dict(img_size=32, patch_size=8, embed_dim=48, depth=3, num_heads=4, num_classes=10)
SCHED = {1: {"keep_ratio": 0.6, "update": True}, 2: {"keep_ratio": 0.5, "update": False}}


def _setup(rng, cfg: dict, layer_scale: bool):
    jcfg = jvit.ViTConfig(**cfg, use_layer_scale=layer_scale)
    tcfg = tvit.ViTConfig(**cfg, use_layer_scale=layer_scale)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0), jcfg))
    for blk in jp["blocks"]:
        blk["norm1"]["scale"] = 1 + 0.1 * rng.standard_normal(blk["norm1"]["scale"].shape).astype(np.float32)
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * rng.standard_normal(d["bias"].shape).astype(np.float32)
        if layer_scale:
            blk["ls1"] = 0.5 * rng.standard_normal(blk["ls1"].shape).astype(np.float32)
            blk["ls2"] = 0.5 * rng.standard_normal(blk["ls2"].shape).astype(np.float32)
    images = rng.standard_normal((2, cfg["img_size"], cfg["img_size"], 3)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp), images


def _spy_routes(monkeypatch) -> dict:
    """Count the port forward's calls of each attention-half entry point."""
    calls = {}
    for name in ("fused_pruned_attn_block", "fused_ln_qkv", "fused_gather_sdpa_proj_residual"):
        fn = getattr(tvit, name)
        calls[name] = 0

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tvit, name, spy)
    return calls


@pytest.mark.parametrize("layer_scale", [False, True])
def test_long_sequence_forward_matches_jax(rng, monkeypatch, layer_scale):
    jcfg, tcfg, jp, tp, images = _setup(rng, LONG_CFG, layer_scale)
    assert tcfg.num_tokens == 325
    monkeypatch.setattr(jblock, "_pruned_block_fits", lambda *a: False)
    monkeypatch.setattr(jblock, "_bf16_full_plan", lambda *a: None)
    jparams = jax.tree.map(jnp.asarray, jp)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    sel = {k: {} for k in ("xla", "pallas", "torch", "cuda")}

    def tap(key):
        return lambda i, k: sel[key].__setitem__(i, np.asarray(k))

    want = {impl: jvit.vit_forward(jparams, jnp.asarray(images), jcfg, jsched, impl,
                                   _sel_tap=tap(impl)) for impl in ("xla", "pallas")}
    calls = _spy_routes(monkeypatch)
    x = torch.from_numpy(images)
    got = {impl: tvit.vit_forward(tp, x, tcfg, SCHED, impl, _sel_tap=tap(impl))
           for impl in ("torch", "cuda")}
    # block 1 (325 tokens) took B4 + B5, block 2 (195 tokens) took K1
    assert calls == {"fused_pruned_attn_block": 1, "fused_ln_qkv": 1,
                     "fused_gather_sdpa_proj_residual": 1}
    np.testing.assert_allclose(got["torch"].numpy(), np.asarray(want["xla"]), **ACT)
    np.testing.assert_allclose(got["cuda"].numpy(), np.asarray(want["pallas"]), **ACT)
    assert all(sorted(s) == [1, 2] for s in sel.values())
    for i in (1, 2):
        for key in ("pallas", "torch", "cuda"):
            np.testing.assert_array_equal(sel[key][i], sel["xla"][i])
    assert tvit.model_stats(tcfg, SCHED) == jvit.model_stats(jcfg, jsched)
    assert tvit.model_stats(tcfg, SCHED)["token_counts"] == [325, 325, 195]


def test_short_sequences_keep_k1(rng, monkeypatch):
    """At N <= 256 (tests/test_torch_forward.py's config) every pruned block
    still takes K1, and the forward still matches JAX ``impl="pallas"``."""
    jcfg, tcfg, jp, tp, images = _setup(rng, SHORT_CFG, False)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    want = jvit.vit_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(images), jcfg, jsched,
                            "pallas")
    calls = _spy_routes(monkeypatch)
    got = tvit.vit_forward(tp, torch.from_numpy(images), tcfg, SCHED, "cuda")
    assert calls == {"fused_pruned_attn_block": 2, "fused_ln_qkv": 0,
                     "fused_gather_sdpa_proj_residual": 0}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_vit_b16_384_token_trace():
    """SURVEY.md:166's trace of ViT-B/16-384 under the reference schedule."""
    cfg = tvit.get_config("vit_base_patch16_384")
    want = [577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356]
    assert tvit.model_stats(cfg, REFERENCE_SCHEDULE)["token_counts"] == want
    jcfg = jvit.get_config("vit_base_patch16_384")
    assert jvit.model_stats(jcfg, REFERENCE_SCHEDULE)["token_counts"] == want


def test_new_wrappers_refuse_other_devices(rng):
    """Off the CPU the B4-B6 wrappers launch their kernels or raise: never the
    plain version on a non-CPU tensor."""
    _, tb = _attn_block(rng, 64)
    x = torch.empty(2, 300, 64, device="meta")
    qkv = torch.empty(2, 300, 192, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsdpa.fused_sdpa(qkv, 1, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblock.fused_ln_qkv(x, tb["norm1"], tb["attn"]["qkv"], 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblock.fused_gather_sdpa_proj_residual(
            qkv, torch.zeros(2, 5, dtype=torch.long), x, tb["attn"]["proj"], None, 1, 0.125)
