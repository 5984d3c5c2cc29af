"""The port's training path against the JAX package: the plain versions of
B16 ``train_attn_block``, B17 ``train_ln_mlp`` and B18 ``train_sdpa_bwd``,
the gradients of ``vit_forward_train`` and of the plain forward under
autograd, the selections, the optimizer and the loss.

The JAX kernels run in interpret mode on the CPU, as
tests/test_train_kernels.py runs them; the port's wrappers take their plain
versions because the tensors lie on the CPU. Inputs come from numpy with a
seed. The narrow config is the port files' (C=128, 2 heads, 64 px, batch 2)
at depth 6, which tests/test_train_kernels.py's SCHED (blocks 3-5) needs.
Tolerances: the kernels rtol 1e-4 / atol 1e-5 in fp32; the loss within
1e-5 and the worst relative gradient (max |Δ| over max |g| per leaf)
within 1e-4 against JAX's kernel path and JAX's XLA-route backward, 1e-3
against ``vit_forward(impl="xla")`` (JAX's own bound between its kernel and
XLA paths); the optimizer 1e-6 on the params.
"""

from __future__ import annotations

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu import train as jtrain
from rajni_tpu.kernels import train as jk
from rajni_tpu.models import train_path as jtp
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch import train as ttrain
from rajni_tpu_torch.kernels import mlp as tmlp
from rajni_tpu_torch.kernels import train as tk
from rajni_tpu_torch.models import train_path as ttp
from rajni_tpu_torch.models import vit as tvit


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ACT = dict(rtol=1e-4, atol=1e-5)
CFG = dict(img_size=64, patch_size=16, embed_dim=128, depth=6, num_heads=2, num_classes=10,
           use_layer_scale=True)
# tests/test_train_kernels.py:24
SCHED = {"3": {"keep_ratio": 0.7, "update": True},
         "4": {"keep_ratio": 0.7, "update": False},
         "5": {"keep_ratio": 0.6, "update": True}}
LABELS = np.array([3, 7])


def _worst_rel(want: dict, got) -> float:
    """Max over leaves of ``max |want − got| / max |want|`` (JAX tree against
    the port's, both through ``params_from_numpy``'s layout)."""
    w = ttrain.param_leaves(params_from_numpy(jax.tree.map(np.asarray, want)))
    return max(float((a - b).abs().max() / (a.abs().max() + 1e-12)) for a, b in zip(w, got))


def _loss_jax(fwd):
    def f(p):
        lg = fwd(p).astype(jnp.float32)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]), LABELS])
    return jax.jit(jax.value_and_grad(f))


def _grads_port(fwd, tp):
    leaves = ttrain.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttrain.cross_entropy(fwd(tp), torch.from_numpy(LABELS))
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def model():
    """JAX params with non-trivial biases, norms and layer scales, the port's
    copy, images, and JAX's loss and gradients on its kernel path."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = jvit.ViTConfig(**CFG), tvit.ViTConfig(**CFG)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0), jcfg))
    C = CFG["embed_dim"]
    for blk in jp["blocks"]:
        for leaf in ("norm1", "norm2"):
            blk[leaf]["scale"] = 1 + 0.1 * rng.standard_normal(C).astype(np.float32)
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * rng.standard_normal(d["bias"].shape).astype(np.float32)
        blk["ls1"] = 0.5 * rng.standard_normal(C).astype(np.float32)
        blk["ls2"] = 0.5 * rng.standard_normal(C).astype(np.float32)
    jp["cls_token"] = 0.1 * rng.standard_normal(jp["cls_token"].shape).astype(np.float32)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    x = jnp.asarray(images)
    kernel = _loss_jax(lambda p: jtp.vit_forward_train(p, x, jcfg, jsched, stock_impl="pallas"))
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": jp, "jparams": jparams, "jsched": jsched,
            "images": images, "kernel": kernel(jparams)}


def _tp(model):
    return params_from_numpy(model["jp"])


def _xla(model):
    """JAX's ``vit_forward(impl="xla")``: ``((loss, kept indices), grads)``,
    the kept indices returned from the traced ``_sel_tap``."""
    if "xla" not in model:
        x = jnp.asarray(model["images"])

        def f(p):
            sel = {}
            lg = jvit.vit_forward(p, x, model["jcfg"], model["jsched"], "xla",
                                  _sel_tap=sel.__setitem__).astype(jnp.float32)
            return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]), LABELS]), sel

        model["xla"] = jax.jit(jax.value_and_grad(f, has_aux=True))(model["jparams"])
    return model["xla"]


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------


def _block_np(rng, C, hidden):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"ln": {"scale": 1 + 0.1 * f(C), "bias": 0.1 * f(C)},
            "qkv": (f(C, 3 * C) / np.sqrt(C), 0.1 * f(3 * C)), "proj": (f(C, C) / np.sqrt(C), 0.1 * f(C)),
            "fc1": (f(C, hidden) / np.sqrt(C), 0.1 * f(hidden)),
            "fc2": (f(hidden, C) / np.sqrt(hidden), 0.1 * f(C)), "ls": 0.5 * f(C)}


def _jlin(p, cast):
    return {"kernel": cast(p[0]), "bias": cast(p[1])}


def _tlin(p, cast):
    return {"weight": cast(np.ascontiguousarray(p[0].T)), "bias": cast(p[1])}


@pytest.mark.parametrize("kernel", ["B16", "B17", "B17 branch", "B18"])
def test_kernel_plain_versions_match_jax(kernel):
    rng = np.random.default_rng(1)
    C, H, hidden = 128, 2, 512
    p = _block_np(rng, C, hidden)
    x = (0.5 * rng.standard_normal((2, 17, C))).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    jln, tln = jax.tree.map(J, p["ln"]), {k: T(v) for k, v in p["ln"].items()}
    scale = (C // H) ** -0.5
    if kernel == "B16":
        want = jk.train_attn_block(J(x), jln, {"qkv": _jlin(p["qkv"], J), "proj": _jlin(p["proj"], J)},
                                   J(p["ls"]), H, scale)
        got = tk.train_attn_block(T(x), tln, {"qkv": _tlin(p["qkv"], T), "proj": _tlin(p["proj"], T)},
                                  T(p["ls"]), H, scale)
    elif kernel.startswith("B17"):
        ar = kernel == "B17"
        want = jk.train_ln_mlp(J(x), jln, {"fc1": _jlin(p["fc1"], J), "fc2": _jlin(p["fc2"], J)},
                               J(p["ls"]), add_residual=ar)
        got = tk.train_ln_mlp(T(x), tln, {"fc1": _tlin(p["fc1"], T), "fc2": _tlin(p["fc2"], T)},
                              T(p["ls"]), add_residual=ar)
    else:
        qkv = rng.standard_normal((2, 29, 3 * C)).astype(np.float32)
        dout = rng.standard_normal((2, 29, C)).astype(np.float32)
        want = jk.train_sdpa_bwd(J(qkv), J(dout), H, scale)
        got = tk.train_sdpa_bwd(T(qkv), T(dout), H, scale)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ACT)


def test_b17_gelu_runs_on_the_rounded_h_bf16():
    """In bf16, B17's plain version agrees with JAX's B17, and the GELU of the
    unrounded h (K3's chain, ``ln_mlp_residual_plain``) visibly misses it."""
    rng = np.random.default_rng(2)
    C, hidden = 128, 512
    p = _block_np(rng, C, hidden)
    x = (0.5 * rng.standard_normal((2, 33, C))).astype(np.float32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    want, want_h = jk.train_ln_mlp(jb(x), jax.tree.map(jb, p["ln"]),
                                   {"fc1": _jlin(p["fc1"], jb), "fc2": _jlin(p["fc2"], jb)})
    tln = {k: tb(v) for k, v in p["ln"].items()}
    tmp = {"fc1": _tlin(p["fc1"], tb), "fc2": _tlin(p["fc2"], tb)}
    got, got_h = tk.train_ln_mlp(tb(x), tln, tmp)
    unrounded = tmlp.ln_mlp_residual_plain(tb(x), tln, tmp)
    want32 = np.asarray(want.astype(jnp.float32))

    def mismatch(t, w=want32):
        return float(np.mean(t.float().numpy() != w))

    assert mismatch(got_h, np.asarray(want_h.astype(jnp.float32))) < 0.002
    assert mismatch(got) < 0.002
    assert mismatch(unrounded) > 10 * max(mismatch(got), 0.002)


# ---------------------------------------------------------------------------
# Gradients, selections and scores
# ---------------------------------------------------------------------------


def test_kernel_path_gradients_match_jax(model):
    """The port's kernel path (plain versions) against JAX's kernel path and
    against JAX's XLA forward; kept indices against the XLA path's."""
    sel = {}
    x = torch.from_numpy(model["images"])
    loss, grads = _grads_port(
        lambda p: ttp.vit_forward_train(p, x, model["tcfg"], SCHED,
                                        _sel_tap=lambda i, k: sel.__setitem__(i, k.numpy())), _tp(model))
    (l_k, g_k), ((l_x, jsel), g_x) = model["kernel"], _xla(model)
    assert abs(loss - float(l_k)) < 1e-5
    assert _worst_rel(g_k, grads) < 1e-4
    assert abs(loss - float(l_x)) < 1e-3
    assert _worst_rel(g_x, grads) < 1e-3
    assert sorted(sel) == sorted(jsel) == [3, 4, 5]
    for i in sel:
        np.testing.assert_array_equal(sel[i], np.asarray(jsel[i]))


def test_torch_route_gradients_match_jax_xla(model):
    """The plain forward under autograd (``--kernels torch``) against JAX's
    ``vit_forward(impl="xla")`` gradients."""
    x = torch.from_numpy(model["images"])
    loss, grads = _grads_port(lambda p: tvit.vit_forward(p, x, model["tcfg"], SCHED, "torch"),
                              _tp(model))
    (l_x, _), g_x = _xla(model)
    assert abs(loss - float(l_x)) < 1e-5
    assert _worst_rel(g_x, grads) < 1e-4


@pytest.mark.parametrize("route", ["B18"])
def test_sdpa_backward_route_parity(model, monkeypatch, route):
    """JAX forced onto its XLA einsum backward (fresh jit: the switch is read
    at trace time) against the port's B18 route, which the port takes at
    every kept count, also where JAX's fit rule sends it to XLA."""
    if "xla_route" not in model:
        monkeypatch.setenv("RAJNI_TRAIN_ATTN_BWD", "xla")
        x = jnp.asarray(model["images"])
        fwd = _loss_jax(lambda p: jtp.vit_forward_train(p, x, model["jcfg"], model["jsched"],
                                                        stock_impl="pallas"))
        model["xla_route"] = fwd(model["jparams"])
        monkeypatch.delenv("RAJNI_TRAIN_ATTN_BWD")
    x = torch.from_numpy(model["images"])
    loss, grads = _grads_port(
        lambda p: ttp.vit_forward_train(p, x, model["tcfg"], SCHED), _tp(model))
    l_x, g_x = model["xla_route"]
    assert abs(loss - float(l_x)) < 1e-5
    assert _worst_rel(g_x, grads) < 1e-4


def test_scores_get_a_zero_gradient(model):
    """A pruned block given threaded scores returns a zero cotangent for
    them; its next_scores and kept indices carry no gradient."""
    tp = _tp(model)
    block = tp["blocks"][4]
    paths = ttp._paths(block)
    leaves = [t.requires_grad_(True) for t in ttp._flatten(block, paths)]
    x = torch.randn(2, 12, 128, generator=torch.Generator().manual_seed(0), requires_grad=True)
    scores = torch.rand(2, 12, generator=torch.Generator().manual_seed(1), requires_grad=True)
    y, ns, idx = ttp._PrunedBlock.apply((2, 0.125, 1e-6, 7, False, paths), x, scores, None, None,
                                        *leaves)
    assert not ns.requires_grad and not idx.requires_grad
    g = torch.autograd.grad(y.square().sum(), scores)[0]
    assert torch.equal(g, torch.zeros_like(scores))


# ---------------------------------------------------------------------------
# Optimizer and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="cosine", warmup_steps=2, grad_clip=1.0, grad_accum=2),
    dict(lr_schedule="constant", warmup_steps=1, grad_clip=0.5, grad_accum=1),
], ids=["cosine-clip-accum", "constant-warmup-clip"])
def test_optimizer_matches_optax(kw):
    """Three updates of ``build_optimizer`` against the JAX package's (optax)
    on the same gradients, micro-steps included."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps = 3 * kw["grad_accum"]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(steps)]
    jtx = jtrain.build_optimizer(1e-2, steps, 0.05, **kw)
    jp = [jnp.asarray(p) for p in params]
    st = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    ttx = ttrain.build_optimizer(1e-2, steps, 0.05, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tst = ttx.init(tp)
    for g in grads:
        upd, st = jupdate([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update([torch.from_numpy(a) for a in g], tst, tp)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    assert not np.allclose(np.asarray(jp[0]), params[0])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((6, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = ttrain.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
