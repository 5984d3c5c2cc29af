"""The port's parallel paths (``rajni_tpu_torch/parallel``) against the JAX
package's ``rajni_tpu/parallel``.

In-process cases first: the head-aligned QKV repack and each model rank's
slice of every leaf against JAX's ``repack_qkv_heads`` / ``param_pspecs``
shards; the scorer's TP partials; the plain versions of B5, B12 and B13 in
their shard forms (C = 128, 2 heads, tp 2) against JAX's kernels in
interpret mode; the batch helpers; the pipeline's stacking; the copied int8
tail rule; the refusals. Then one module fixture spawns four gloo CPU ranks
once (one torch thread each) and runs every multi-rank case there; each case
is a test of its own, held in this process against JAX on the conftest's 8
CPU devices: DP × TP (2, 2) pruned and stock on the kernels' plain versions
(JAX's ``tp_pallas_forward``), the torch route against JAX's XLA TP, int8
dynamic and static (and the bf16 tail where the int8 one does not fit)
against JAX's ``tp_pallas_forward``, not single-chip; DP over 4 ranks and
``eval_step_fn``; the pipeline over (data 2, pipe 2) and (pipe 2, model 2);
``evaluate_model_multihost`` with ragged shards.

The ranks import this module without JAX (the spawn start method imports the
worker's module), so JAX and the JAX package are imported inside the tests.

Tolerances: fp32 everywhere. The forwards compute the same operations in
the same order up to the frameworks' matmul summation orders: logits rtol
1e-4 / atol 1e-5 of the largest logit (tests/test_parallel.py's TP bound is
2e-4 against single-device). Int8: the products are exact on both sides and
dequantized in the same order, so only an activation within an fp32
rounding of a quantization tie can round to a neighbouring step (a one-step
flip, tests/test_torch_wholeblock.py), which moves the logits of the image
that holds it by less than INT8_FLIP = 0.05: at most a quarter of the images
may leave rtol 1e-4 / atol 1e-5, every logit within INT8_FLIP. (At this
seed the single-device static int8 forwards of the two packages already
differ by one such flip; the TP forward reproduces the port's single-device
static logits bit for bit.) Counters exact.
"""

from __future__ import annotations

import unittest.mock

import numpy as np
import pytest
import torch

from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch import quant as tquant
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.models.vit import ViTConfig as TConfig
from rajni_tpu_torch.ops import importance as timp
from rajni_tpu_torch.parallel import launch, mesh as tmesh, multihost as tmh, pipeline as tpipe
from rajni_tpu_torch.utils.schedule import normalize_schedule as tnorm

# depth 2: one block a stage in the pipeline, whose second stage takes the
# first's scores (update False); the stock blocks are the stock case's
CFG = dict(img_size=32, patch_size=8, embed_dim=256, depth=2, num_heads=4, mlp_ratio=2.0,
           num_classes=13, use_layer_scale=True)
SCHED = {0: {"keep_ratio": 0.8}, 1: {"keep_ratio": 0.7, "update": False}}
B = 8
ACT = dict(rtol=1e-4, atol=1e-5)
MH_ROWS = 13  # over 4 ranks at 2 a step: shards of 4, 3, 3 and 3 rows
DP_ROWS = 6  # over 4 data ranks: padded to 8
INT8_FLIP = 5e-2
TCFG = TConfig(**CFG)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed: int = 0) -> dict:
    """A random JAX-layout tree (numpy) with non-zero biases and layer
    scales, so a shard that adds the residual or a bias twice shows."""
    rng = np.random.default_rng(seed)
    C, P, depth = CFG["embed_dim"], CFG["patch_size"], CFG["depth"]
    hidden = int(C * CFG["mlp_ratio"])
    n_tok = (CFG["img_size"] // P) ** 2 + 1

    def dense(fi, fo):
        return {"kernel": (rng.standard_normal((fi, fo)) / np.sqrt(fi)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(fo)).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}

    def ls():
        return (0.5 + 0.1 * rng.standard_normal(C)).astype(np.float32)

    return {
        "patch_embed": dense(P * P * 3, C),
        "cls_token": (0.02 * rng.standard_normal((1, 1, C))).astype(np.float32),
        "pos_embed": (0.02 * rng.standard_normal((1, n_tok, C))).astype(np.float32),
        "blocks": [{"norm1": norm(), "attn": {"qkv": dense(C, 3 * C), "proj": dense(C, C)},
                    "norm2": norm(), "mlp": {"fc1": dense(C, hidden), "fc2": dense(hidden, C)},
                    "ls1": ls(), "ls2": ls()} for _ in range(depth)],
        "norm": norm(),
        "head": dense(C, CFG["num_classes"]),
    }


def _images(seed: int = 1, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _jquantize(np_params):
    jax, jnp = _jax()
    from rajni_tpu.quant import quantize_params

    return jax.tree.map(np.asarray, quantize_params(jax.tree.map(jnp.asarray, np_params)))


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=ACT["rtol"],
                               atol=ACT["atol"] * np.abs(want).max(), err_msg=what)


def _int8_close(got, want, what: str) -> None:
    """Int8 logits: every image within ACT but those a one-step flip moved
    (at most a quarter of them), and every logit within INT8_FLIP."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    off = ~np.isclose(got, want, **ACT).all(axis=1)
    err = np.abs(got - want).max()
    assert off.mean() <= 0.25 and err <= INT8_FLIP, f"{what}: {off.sum()} images off, {err:.3e}"


# ---------------------------------------------------------------------------
# In-process: params, scorer, shard kernels, helpers, refusals
# ---------------------------------------------------------------------------


def _one_rank_mesh(model: int, coord: int) -> tmesh.Mesh:
    """A mesh as rank ``coord`` of a model line sees it (no process group:
    only :func:`shard_params` reads it)."""
    return tmesh.Mesh({"data": 1, "model": model}, {"data": 0, "model": coord},
                      {"data": [0], "model": list(range(model))}, {}, torch.device("cpu"))


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_shards_match_jax(int8):
    """Repack round trip, and each model rank's slice of every leaf equal
    to JAX's ``shard_params`` shard of it (JAX ``[in, out]`` transposed)."""
    jax, jnp = _jax()
    from rajni_tpu.parallel import mesh as jmesh

    np_params = _np_params()
    if int8:
        np_params = _jquantize(np_params)
    tparams = params_from_numpy(np_params)
    back = tmesh.unrepack_qkv_heads(tmesh.repack_qkv_heads(tparams))
    w0 = tparams["blocks"][0]["attn"]["qkv"]["weight"]
    w1 = back["blocks"][0]["attn"]["qkv"]["weight"]
    for a, b in ((w0["int8"], w1["int8"]) if int8 else (w0, w1),):
        assert torch.equal(a, b)
    jm = jmesh.make_mesh(jax.devices()[:2], data=1, model=2)
    jsh = jmesh.shard_params(jax.tree.map(jnp.asarray, np_params), jm)
    for r in range(2):
        local = tmesh.shard_params(tparams, _one_rank_mesh(2, r))

        def jshard(a):
            return np.asarray(a.addressable_shards[r].data)

        for i, (jb, tb) in enumerate(zip(jsh["blocks"], local["blocks"])):
            for grp, name in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
                jk, tw = jb[grp][name]["kernel"], tb[grp][name]["weight"]
                if int8:
                    ji, ts = jshard(jk["int8"]), jshard(jk["scale"]).reshape(-1)
                    tw, tsc = tw["int8"], tw["scale"]
                    np.testing.assert_array_equal(tsc.reshape(-1).numpy(), ts)
                else:
                    ji = jshard(jk)
                if name == "qkv":  # JAX [C, 3, C_l] → the port's [3, C_l, C]
                    ji = ji.transpose(1, 2, 0)
                else:
                    ji = ji.T
                np.testing.assert_array_equal(tw.numpy(), ji, err_msg=f"block {i} {name}")
                np.testing.assert_array_equal(
                    tb[grp][name]["bias"].reshape(-1).numpy(),
                    jshard(jb[grp][name]["bias"]).reshape(-1))
        # the kernels' local packing: [3C_l, C] rows of q, k, v heads of this shard
        qkv = tmesh.local_qkv(local["blocks"][0]["attn"]["qkv"])["weight"]
        full = tparams["blocks"][0]["attn"]["qkv"]["weight"]
        full = full["int8"] if int8 else full
        C = CFG["embed_dim"]
        want = torch.cat([full[j * C + r * C // 2: j * C + (r + 1) * C // 2] for j in range(3)])
        assert torch.equal(qkv["int8"] if int8 else qkv, want)


def test_importance_partials_match_jax():
    """The per-shard partial sums, their sum over two shards completed, equal
    JAX's partials/completion and the port's full-head ``compute_importance``."""
    jax, jnp = _jax()
    from rajni_tpu.ops import importance as jimp

    rng = np.random.default_rng(3)
    H, D, N = 4, 64, 17
    qkv = rng.standard_normal((2, N, 3 * H * D)).astype(np.float32)
    full = qkv.reshape(2, N, 3, H, D)
    shards = [full[:, :, :, r * 2:(r + 1) * 2].reshape(2, N, -1) for r in range(2)]
    parts = [timp.importance_partials(torch.from_numpy(s), 2) for s in shards]
    jparts = [jimp.importance_partials(jnp.asarray(s), 2) for s in shards]
    for (a, v), (ja, jv) in zip(parts, jparts):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    got = timp.importance_from_partials(parts[0][0] + parts[1][0], parts[0][1] + parts[1][1], H)
    want = jimp.importance_from_partials(jparts[0][0] + jparts[1][0],
                                         jparts[0][1] + jparts[1][1], H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.numpy(),
                               timp.compute_importance(torch.from_numpy(qkv), H).numpy(),
                               rtol=1e-5, atol=1e-7)


def _shard_block(rng, int8: bool):
    """ViT-B-like narrow block at C = 128, 2 heads, and rank 0's tp-2 shard
    of its qkv and proj (JAX layout), with JAX-quantized records."""
    jax, jnp = _jax()
    from rajni_tpu.quant import quantize_weight

    C, C_l = 128, 64
    wqkv = (rng.standard_normal((C, 3, C)) / np.sqrt(C)).astype(np.float32)[:, :, :C_l]
    wqkv = wqkv.reshape(C, 3 * C_l)
    wproj = (rng.standard_normal((C_l, C)) / np.sqrt(C)).astype(np.float32)
    ln = {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    bqkv = (0.05 * rng.standard_normal(3 * C_l)).astype(np.float32)
    if int8:
        wqkv = jax.tree.map(np.asarray, quantize_weight(jnp.asarray(wqkv)))
        wproj = jax.tree.map(np.asarray, quantize_weight(jnp.asarray(wproj)))
    return ln, {"kernel": wqkv, "bias": bqkv}, {"kernel": wproj,
                                                 "bias": np.zeros(C, np.float32)}


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_shard_kernels_plain_match_jax(static):
    """B12's, B13's and B5's plain versions at a tp-2 shard (C = 128, one
    head of 64 a shard) against JAX's kernels in interpret mode: qkv
    ``[B, N, 3C_l]`` without scores, then the partial proj sums on a zero
    residual and bias (B13 quantizing each row over C_l; B5 on the
    dequantized proj)."""
    jax, jnp = _jax()
    from rajni_tpu.kernels import block as jblock
    from rajni_tpu.ops.pruning import select_tokens_dense
    from rajni_tpu.quant import dequantize_weight
    from rajni_tpu_torch.params.from_jax import _dense, _norm

    rng = np.random.default_rng(5)
    ln, qkv_p, proj_p = _shard_block(rng, int8=True)
    x = rng.standard_normal((2, 17, 128)).astype(np.float32)
    ls = (0.5 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    acts = (4 / 127, 2 / 127) if static else None
    jq, _ = jblock.fused_ln_qkv_int8(jnp.asarray(x), ln, qkv_p, 1, 1e-6, False, act_scales=acts)
    tq, _ = tblock.fused_ln_qkv_int8(torch.from_numpy(x), _norm(ln), _dense(qkv_p), 1, 1e-6,
                                     False, act_scales=acts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **ACT)
    assert tq.shape == (2, 17, 192)
    scores = rng.random((2, 17)).astype(np.float32)
    idx, sel = select_tokens_dense(jnp.asarray(scores), 11, jnp.float32)
    zeros = np.zeros_like(x)
    j13 = jblock.fused_gather_sdpa_proj_residual_int8(
        jq, sel, jnp.asarray(zeros), proj_p, jnp.asarray(ls), 1, 0.125,
        act_scale=None if acts is None else acts[1])
    t13 = tblock.fused_gather_sdpa_proj_residual_int8(
        torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(idx)),
        torch.from_numpy(zeros), _dense(proj_p), torch.from_numpy(ls), 1, 0.125,
        None if acts is None else acts[1])
    np.testing.assert_allclose(t13.numpy(), np.asarray(j13), **ACT)
    wp = {"kernel": np.asarray(dequantize_weight(proj_p["kernel"])), "bias": proj_p["bias"]}
    j5 = jblock.fused_gather_sdpa_proj_residual(jq, sel, jnp.asarray(zeros), wp,
                                                jnp.asarray(ls), 1, 0.125)
    t5 = tblock.fused_gather_sdpa_proj_residual(
        torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(idx)),
        torch.from_numpy(zeros), _dense(wp), torch.from_numpy(ls), 1, 0.125)
    np.testing.assert_allclose(t5.numpy(), np.asarray(j5), **ACT)


def test_shard_widths_refused_before_dispatch():
    """The shard forms' width rules: B12 refuses scores on a shard, B5 and
    B13 a proj whose width is not the qkv's; the TP route rule on the card
    (ViT-B at tp 4: C/tp = 192) raises under ``cuda``, demotes under
    ``auto``, and takes tp 2."""
    rng = np.random.default_rng(5)
    ln, qkv_p, proj_p = _shard_block(rng, int8=True)
    from rajni_tpu_torch.params.from_jax import _dense, _norm

    x = torch.zeros(2, 17, 128)
    with pytest.raises(ValueError, match="score"):
        tblock.fused_ln_qkv_int8(x, _norm(ln), _dense(qkv_p), 1, 1e-6, True)
    with pytest.raises(ValueError, match="with_scores"):
        tblock.ln_qkv_plain(x, _norm(ln), {"weight": torch.zeros(192, 128),
                                           "bias": torch.zeros(192)}, 1, 1e-6, True)
    vit_b = TConfig()
    assert tmesh.resolve_tp_route("cuda", vit_b, torch.bfloat16, "cuda", 2) == ("cuda", "")
    with pytest.raises(ValueError, match="C/tp = 768/4 = 192"):
        tmesh.resolve_tp_route("cuda", vit_b, torch.bfloat16, "cuda", 4)
    impl, why = tmesh.resolve_tp_route("auto", vit_b, torch.bfloat16, "cuda", 4)
    assert impl == "torch" and "192 is not a multiple of 128" in why
    assert tmesh.resolve_tp_route("auto", vit_b, torch.bfloat16, "cpu", 4)[0] == "torch"
    with pytest.raises(ValueError, match="must divide num_heads"):
        tmesh.resolve_tp_route("auto", vit_b, torch.bfloat16, "cuda", 5)


def test_int8_tail_rule_matches_jax():
    """The TP int8 tail choice is JAX's (``mesh.py:514-520``) on a grid of
    entry counts, keep ratios, widths and itemsizes."""
    from rajni_tpu.kernels import block as jblock
    from rajni_tpu.ops.pruning import keep_count
    from rajni_tpu.utils.schedule import PruneSpec

    for n in (197, 257, 577, 785, 1025):
        for ratio in (0.5, 0.9):
            for C, tp in ((768, 2), (1024, 4), (1280, 2), (384, 2)):
                for itemsize in (2, 4):
                    spec = PruneSpec(keep_ratio=ratio)
                    want = jblock._gather_fits_fast(n, keep_count(ratio, n) + 1,
                                                    max(C // tp, C), itemsize)
                    assert tmesh.tp_int8_tail(True, spec, n, C // tp, C, itemsize) == want
                    assert tmesh.tp_int8_tail(True, None, n, C // tp, C, itemsize)
                    assert not tmesh.tp_int8_tail(False, spec, n, C // tp, C, itemsize)


def test_batch_helpers_match_jax(monkeypatch):
    """``local_batch_size``, ``shard_samples``, ``steps_for`` and
    ``_pad_to_local`` on a grid of process counts, against JAX's with its
    process (and device) count set to the same (a rank is one device)."""
    jax, _ = _jax()
    from rajni_tpu.parallel import multihost as jmh

    samples = list(range(23))
    for nproc in (1, 2, 3, 4):
        for pid in range(nproc):
            monkeypatch.setattr(jax, "process_count", lambda n=nproc: n)
            monkeypatch.setattr(jax, "device_count", lambda n=nproc: n)
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            monkeypatch.setattr(tmh, "world_size", lambda n=nproc: n)
            monkeypatch.setattr(tmh, "world_rank", lambda p=pid: p)
            assert tmh.shard_samples(samples) == jmh.shard_samples(samples)
            for gb in (8, 12, 13):
                for strict in (False, True):
                    try:
                        want = jmh.local_batch_size(gb, strict)
                    except ValueError:
                        with pytest.raises(ValueError):
                            tmh.local_batch_size(gb, strict)
                        continue
                    assert tmh.local_batch_size(gb, strict) == want
        for total in (0, 1, 7, 23, 100):
            for gb in (4, 12):
                if gb % nproc:
                    with pytest.raises(ValueError):
                        tmh.steps_for(total, gb, nproc)
                    continue
                assert tmh.steps_for(total, gb, nproc) == jmh.steps_for(total, gb, nproc)
    x = np.ones((3, 4, 4, 3), np.float32)
    y = np.array([1, 2, 3])
    gx, gy = tmh._pad_to_local(x, y, 5)
    wx, wy = jmh._pad_to_local(x, y, 5)
    np.testing.assert_array_equal(gx, np.asarray(wx))
    np.testing.assert_array_equal(gy, np.asarray(wy))
    with pytest.raises(ValueError, match="exceeds"):
        tmh._pad_to_local(x, y, 2)
    padded, b = tmesh._pad_batch(torch.ones(5, 2), 4)
    assert b == 5 and padded.shape == (8, 2) and float(padded[5:].abs().sum()) == 0


@pytest.mark.parametrize("tp", [1, 2])
def test_stack_params_match_jax(tp):
    """``stack_params`` / ``unstack_params`` round trip, and each stacked
    leaf JAX's (transposed to ``[out, in]``; the repacked QKV with tp 2)."""
    jax, jnp = _jax()
    from rajni_tpu.parallel import pipeline as jpipe

    np_params = _np_params()
    tparams = params_from_numpy(np_params)
    st = tpipe.stack_params(tparams, 2, tp)
    js = jpipe.stack_params(jax.tree.map(jnp.asarray, np_params), 2, tp)
    wq, jq = st["blocks"]["attn"]["qkv"]["weight"], np.asarray(js["blocks"]["attn"]["qkv"]["kernel"])
    want = jq.transpose(0, 2, 3, 1) if tp > 1 else jq.transpose(0, 2, 1)
    np.testing.assert_array_equal(wq.numpy(), want)
    np.testing.assert_array_equal(st["blocks"]["mlp"]["fc2"]["weight"].numpy(),
                                  np.asarray(js["blocks"]["mlp"]["fc2"]["kernel"]).transpose(0, 2, 1))
    back = tpipe.unstack_params(st)
    if tp > 1:
        back = tmesh.unrepack_qkv_heads(back)
    for a, b in zip(back["blocks"], tparams["blocks"]):
        assert torch.equal(a["attn"]["qkv"]["weight"], b["attn"]["qkv"]["weight"])
        assert torch.equal(a["mlp"]["fc1"]["bias"], b["mlp"]["fc1"]["bias"])


def test_refusals():
    """JAX's refusals: partial topologies, int8 and extended variants in the
    pipeline, kernels in the pipeline, TP over processes, a mesh that does
    not tile the ranks; and the eval CLI's flag rules."""
    from rajni_tpu_torch import run

    with pytest.raises(ValueError, match="requires num_processes"):
        tmh.initialize("localhost:1", num_processes=2)
    with pytest.raises(ValueError, match="require coordinator_address"):
        tmh.initialize(process_id=0)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        tmesh.make_mesh(data=2, device="cpu")
    tparams = params_from_numpy(_np_params())
    with pytest.raises(NotImplementedError, match="int8"):
        tpipe.stack_params(tquant.quantize_params(tparams), 1)
    with pytest.raises(ValueError, match="divisible by pipe"):
        tpipe.stack_params(tparams, 3)
    with pytest.raises(ValueError, match="classic"):
        tpipe.pipeline_forward(tparams, TConfig(**CFG, reg_tokens=2), None,
                               tpipe.make_pipe_mesh(1, device="cpu"))
    with pytest.raises(NotImplementedError, match="plain ops"):
        tpipe.pipeline_forward(tparams, TCFG, None, tpipe.make_pipe_mesh(1, device="cpu"),
                               impl="cuda")
    with pytest.raises(NotImplementedError, match="model axis"):
        tmh.multihost_eval_step(TCFG, None, _one_rank_mesh(2, 0))
    base = ["--synthetic", "1", "--device", "cpu", "--schedule", "s.json"]
    for extra, what in ((["--distributed", "--tensor_parallel", "2"], "not supported"),
                        (["--pipeline_parallel", "2", "--quantize"], "plain bf16/f32"),
                        (["--pipeline_parallel", "2", "--preprocess", "device-full"],
                         "device-full"),
                        (["--distributed", "--quantize", "--calibrate", "1"], "--calibrate"),
                        (["--artifact", "a.rajni", "--tensor_parallel", "2"], "parallelism")):
        with pytest.raises(ValueError, match=what):
            run._check_parallel_args(run.get_args(base + extra))


def test_build_lock_is_across_processes(tmp_path, monkeypatch):
    """``kernels/build.py`` holds an ``fcntl`` lock over the build: a build
    that meets the lock held (another process compiling) waits, and once the
    library is there it compiles nothing."""
    import fcntl
    import threading

    from rajni_tpu_torch.kernels import build

    lib = tmp_path / "b" / build.LIBRARY
    monkeypatch.setattr(build, "library_path", lambda: lib)
    calls = []
    monkeypatch.setattr(build, "_compile", lambda path: calls.append(path) or {"x": ""})
    lib.parent.mkdir()
    got = []
    with open(lib.parent / ".lock", "w") as held:  # flock: per open file, so this one excludes
        fcntl.flock(held, fcntl.LOCK_EX)
        waiter = threading.Thread(target=lambda: got.append(build.build()))
        waiter.start()
        waiter.join(timeout=0.5)
        assert waiter.is_alive() and not got  # waiting on the lock
        lib.write_bytes(b"")  # the other process's library, then its unlock
    waiter.join(timeout=10)
    assert got == [{}] and not calls


# ---------------------------------------------------------------------------
# Four gloo CPU ranks, spawned once
# ---------------------------------------------------------------------------


def _ragged_loader(images, labels, rank: int, world: int, local_b: int):
    """This rank's interleaved shard of the rows, in batches of ``local_b``
    (the last one short)."""
    rows = list(range(len(labels)))[rank::world]
    return [(images[rows[i:i + local_b]], labels[rows[i:i + local_b]])
            for i in range(0, len(rows), local_b)]


def _rank_cases(np_params, np_qparams, scales, images, mh_images, labels):
    """Every multi-rank case on this rank; returns ``{case: numpy}``."""
    params, qparams = params_from_numpy(np_params), params_from_numpy(np_qparams)
    act = tquant.ActScales.from_dict(scales)
    x = torch.from_numpy(images)
    sched = tnorm(SCHED, CFG["depth"])
    out = {}
    m22 = tmesh.make_mesh(data=2, model=2, device="cpu")
    out["tp_pruned"] = tmesh.sharded_forward(params, TCFG, sched, m22, "cuda")(x)
    out["tp_stock"] = tmesh.sharded_forward(params, TCFG, None, m22, "cuda")(x)
    out["tp_torch"] = tmesh.sharded_forward(params, TCFG, sched, m22, "torch")(x)
    out["tp_int8_dynamic"] = tmesh.sharded_forward(qparams, TCFG, sched, m22, "cuda")(x)
    out["tp_int8_static"] = tmesh.sharded_forward(qparams, TCFG, sched, m22, "cuda",
                                                  act_scales=act)(x)
    with unittest.mock.patch.object(tmesh, "_gather_fits_fast", lambda *a, **k: False):
        out["tp_int8_unfit"] = tmesh.sharded_forward(qparams, TCFG, sched, m22, "cuda",
                                                     act_scales=act)(x)
    m41 = tmesh.make_mesh(data=4, model=1, device="cpu")
    out["dp"] = tmesh.sharded_forward(params, TCFG, sched, m41, "torch")(
        torch.from_numpy(mh_images[:DP_ROWS]))
    pm = tpipe.make_pipe_mesh(pipe=2, data=2, device="cpu")
    out["pipeline"] = tpipe.pipeline_forward(params, TCFG, sched, pm, microbatch=2)(x[:7])
    pm_tp = tpipe.make_pipe_mesh(pipe=2, model=2, device="cpu")
    out["pipeline_tp"] = tpipe.pipeline_forward(params, TCFG, sched, pm_tp, microbatch=2)(x[:7])
    out["eval_step"] = np.array(tmesh.eval_step_fn(TCFG, sched, m41)(
        params, mh_images[:B], labels[:B]))
    rank, world = tmesh.world_rank(), tmesh.world_size()
    loader = _ragged_loader(mh_images, labels, rank, world, 2)
    out["multihost"] = tmh.evaluate_model_multihost(
        params, TCFG, sched, loader, m41, warmup=1,
        num_batches=tmh.steps_for(len(labels), 2 * world, world), local_batch=2)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def _jax_refs(np_params, np_qparams, scales, images, mh_images) -> dict:
    """JAX's outputs for every case (computed while the ranks run)."""
    jax, jnp = _jax()
    from rajni_tpu.models.vit import ViTConfig, vit_forward
    from rajni_tpu.parallel import mesh as jmesh
    from rajni_tpu.parallel import pipeline as jpipe
    from rajni_tpu.quant import ActScales
    from rajni_tpu.utils.schedule import normalize_schedule

    cfg, sched = ViTConfig(**CFG), normalize_schedule(SCHED, CFG["depth"])
    jp, jq = (jax.tree.map(jnp.asarray, t) for t in (np_params, np_qparams))
    act = ActScales(tuple(tuple(r) for r in scales["blocks"]), scales["head"])
    x = jnp.asarray(images)
    m22 = jmesh.make_mesh(jax.devices()[:4], data=2, model=2)

    def tp(params, s=sched, impl="pallas", act_scales=None):
        return np.asarray(jmesh.sharded_forward(params, cfg, s, m22, impl=impl,
                                                act_scales=act_scales)(x))

    refs = {"tp_pruned": tp(jp), "tp_stock": tp(jp, None), "tp_torch": tp(jp, impl="xla"),
            "tp_int8_dynamic": tp(jq), "tp_int8_static": tp(jq, act_scales=act)}
    m = jpipe.make_pipe_mesh(jax.devices()[:4], pipe=2, data=2)
    refs["pipeline"] = np.asarray(jpipe.pipeline_forward(jp, cfg, sched, m, microbatch=2)(x[:7]))
    m = jpipe.make_pipe_mesh(jax.devices()[:4], pipe=2, data=1, model=2)
    refs["pipeline_tp"] = np.asarray(jpipe.pipeline_forward(jp, cfg, sched, m,
                                                            microbatch=2)(x[:7]))
    single = jax.jit(vit_forward, static_argnums=(2, 3))
    refs["single"] = np.asarray(single(jp, jnp.asarray(mh_images), cfg, sched))
    return refs


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' results, JAX's references, and the inputs. The ranks'
    inputs come from the port (int8 records by its ``quantize_params``, the
    static scales by its ``calibrate_act_scales``), so the ranks start before
    JAX's references are computed, and both run at once."""
    from rajni_tpu_torch.models.vit import vit_forward
    from rajni_tpu_torch.params.from_jax import params_to_numpy

    np_params = _np_params()
    tparams = params_from_numpy(np_params)
    np_qparams = params_to_numpy(tquant.quantize_params(tparams))
    images, mh_images = _images(), _images(seed=3, n=MH_ROWS)
    sched = tnorm(SCHED, CFG["depth"])
    scales = tquant.calibrate_act_scales(tparams, torch.from_numpy(images), TCFG,
                                         sched).to_dict()
    # half the labels the model's own top-1, so the counters are not all zero
    labels = np.random.default_rng(2).integers(0, 13, MH_ROWS).astype(np.int64)
    with torch.no_grad():
        own = vit_forward(tparams, torch.from_numpy(mh_images), TCFG, sched).argmax(-1)
    labels[::2] = own.numpy()[::2]
    started = launch.start(_rank_cases, 4,
                           (np_params, np_qparams, scales, images, mh_images, labels),
                           device_type="cpu", threads=1)
    refs = _jax_refs(np_params, np_qparams, scales, images, mh_images)
    return dict(results=started.join(), refs=refs, labels=labels)


def _same_on_ranks(ranks, case):
    got = [r[case] for r in ranks["results"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0], err_msg=f"{case}: ranks disagree")
    return got[0]


@pytest.mark.parametrize("case", ["tp_pruned", "tp_stock"])
def test_tp_kernels_match_jax(ranks, case):
    """DP × TP (2, 2) on the kernels' plain versions against JAX's
    ``tp_pallas_forward`` (interpret mode), pruned (update False included)
    and stock."""
    _close(_same_on_ranks(ranks, case), ranks["refs"][case], case)


def test_tp_torch_route_matches_jax(ranks):
    """The torch route's TP (``_tp_block``) against JAX's XLA TP."""
    _close(_same_on_ranks(ranks, "tp_torch"), ranks["refs"]["tp_torch"], "tp_torch")


@pytest.mark.parametrize("case", ["tp_int8_dynamic", "tp_int8_static"])
def test_tp_int8_matches_jax(ranks, case):
    """Int8 TP against JAX's ``tp_pallas_forward`` on the same records:
    dynamic (each row-parallel site quantized over its shard's columns) and
    static (calibrated scales, V folded on the shard)."""
    _int8_close(_same_on_ranks(ranks, case), ranks["refs"][case], case)


def test_tp_int8_unfit_tail_falls_back(ranks):
    """Where the int8 gather tail does not fit, the pruned blocks take the
    dequantized bf16 tail with B12 unfolded, as JAX does: the counterpart of
    ``tests/test_parallel.py:test_tp_pallas_int8_unfit_tail_falls_back``
    (finite, within 0.2 of the fp32 forward's largest logit; a B12 that
    folded 1/a_proj into V before the bf16 tail would scale the attention by
    1/a_proj), and unlike the int8 tail's logits (the rule was taken)."""
    got = _same_on_ranks(ranks, "tp_int8_unfit")
    ref32 = _same_on_ranks(ranks, "tp_pruned")
    assert np.isfinite(got).all()
    assert np.abs(got - ref32).max() / np.abs(ref32).max() < 0.2
    assert np.abs(got - _same_on_ranks(ranks, "tp_int8_static")).max() > 0


def test_dp_matches_jax(ranks):
    """DP over 4 ranks (a ragged batch of 6 padded to 8): each data rank's
    single-device forward, against JAX's single-device forward."""
    _close(_same_on_ranks(ranks, "dp"), ranks["refs"]["single"][:DP_ROWS], "dp")


@pytest.mark.parametrize("case", ["pipeline", "pipeline_tp"])
def test_pipeline_matches_jax(ranks, case):
    """GPipe over (data 2, pipe 2), and over (pipe 2, model 2) with TP
    inside each stage, 2 microbatches, 7 images padded, against JAX's
    ``pipeline_forward`` on the same mesh."""
    _close(_same_on_ranks(ranks, case), ranks["refs"][case], case)


def test_eval_step_counters(ranks):
    """``eval_step_fn`` over 4 data ranks: the counters of JAX's
    single-device forward on the same 8 rows, summed over ``data``."""
    logits = ranks["refs"]["single"][:B]
    want = [int((logits.argmax(-1) == ranks["labels"][:B]).sum()), B]
    assert _same_on_ranks(ranks, "eval_step").tolist() == want


def test_multihost_ragged_counters(ranks):
    """``evaluate_model_multihost`` over 4 ranks whose interleaved shards
    differ in size: every rank reports the global top-1 of JAX's
    single-device forward on all rows (padding rows counted nowhere)."""
    logits = ranks["refs"]["single"]
    want = 100.0 * float((logits.argmax(-1) == ranks["labels"]).sum()) / MH_ROWS
    assert 0 < want < 100
    accs = [r["multihost"][0] for r in ranks["results"]]
    assert accs == [want] * 4
    assert all(r["multihost"][1] > 0 for r in ranks["results"])
