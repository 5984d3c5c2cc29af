"""The port's training path at ViT-H/14's head_dim 80 against the JAX package.

A narrow ViT-H-shaped config, as tests/test_torch_head_dim80.py's: C = 160, 2
heads of 80, hidden 640, 56 px images in 14 px patches (17 tokens), depth 4,
keep 0.7 at blocks 1 and 2, batch 2. Params come from numpy with a seed
through ``params_from_numpy``; the JAX kernels run in interpret mode on the
CPU, as tests/test_torch_train.py runs them, and the port's wrappers take
their plain versions because the tensors lie on the CPU.

Held here: B18's plain version at head_dim 80 against JAX's
``train_sdpa_bwd`` in fp32 (rtol 1e-4 / atol 1e-5), and in bf16 nearer to it
than the phased form (q·scale rounded to bf16 before q·kᵀ, the forward
kernels' ``_mha`` at 80^-0.5), which B18 must not take; B17's plain version
at ViT-H's C = 1280 and hidden 5120 on a few rows; ``vit_forward_train``'s
loss (within 1e-5), gradients (worst relative 1e-4, max |Δ| over max |g| per
leaf) and selections (exactly) against JAX's kernel path; and the training
CLI on ``--device cpu`` at the narrow config.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.kernels import train as jk
from rajni_tpu.models import train_path as jtp
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch import train as ttrain
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
CFG = dict(img_size=56, patch_size=14, embed_dim=160, depth=4, num_heads=2, num_classes=10)
SCHED = {1: {"keep_ratio": 0.7}, 2: {"keep_ratio": 0.7}}
SCALE = 80 ** -0.5
LABELS = np.array([3, 7])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _phased_bwd(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float):
    """B18's plain version in the phased form: q·scale rounded to the
    activation dtype first, the logits unscaled, dQ scaled back."""
    C = qkv.shape[-1] // 3
    q_scaled = (qkv[..., :C].float() * scale).to(qkv.dtype)
    out, d_qkv = tk.train_sdpa_bwd_plain(torch.cat([q_scaled, qkv[..., C:]], dim=-1), dout,
                                         num_heads, 1.0)
    dq = (d_qkv[..., :C].float() * scale).to(qkv.dtype)
    return out, torch.cat([dq, d_qkv[..., C:]], dim=-1)


def _sdpa_inputs(rng, K):
    qkv = rng.standard_normal((2, K, 3 * 160)).astype(np.float32)
    dout = rng.standard_normal((2, K, 160)).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("K", [17, 61])
def test_b18_plain_matches_jax_at_head_dim_80(K):
    rng = np.random.default_rng(K)
    qkv, dout = _sdpa_inputs(rng, K)
    want = jk.train_sdpa_bwd(jnp.asarray(qkv), jnp.asarray(dout), 2, SCALE)
    got = tk.train_sdpa_bwd(torch.from_numpy(qkv), torch.from_numpy(dout), 2, SCALE)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ACT)


def test_b18_takes_the_per_head_form_not_the_phased_one_bf16():
    """In bf16 the plain version lies nearer JAX's B18 than the phased form,
    per output by relative L2: measured 0 (attn_out, dV) to 5.7e-5 (dQ) from
    JAX, against 3.3e-3 (attn_out) to 4.1e-3 (dQ) for the phased form."""
    rng = np.random.default_rng(5)
    qkv, dout = _sdpa_inputs(rng, 61)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    want = jk.train_sdpa_bwd(jb(qkv), jb(dout), 2, SCALE)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    per_head = tk.train_sdpa_bwd(tb(qkv), tb(dout), 2, SCALE)
    phased = _phased_bwd(tb(qkv), tb(dout), 2, SCALE)

    def parts(pair):
        out, d = (t.float().numpy() if isinstance(t, torch.Tensor) else t for t in pair)
        return {"attn_out": out, "dQ": d[..., :160], "dK": d[..., 160:320], "dV": d[..., 320:]}

    w, g, p = parts(want), parts(per_head), parts(phased)
    for key in w:
        near, far = _rel(g[key], w[key]), _rel(p[key], w[key])
        assert near < 2e-4, (key, near)
        assert far > 2e-3, (key, far)


def test_b17_plain_matches_jax_at_vit_h_width():
    """B17 at C = 1280, hidden 5120 on three rows."""
    rng = np.random.default_rng(7)
    C, hidden = 1280, 5120
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = 0.5 * f(1, 3, C)
    ln = {"scale": 1 + 0.1 * f(C), "bias": 0.1 * f(C)}
    fc1 = (f(C, hidden) / np.sqrt(C), 0.1 * f(hidden))
    fc2 = (f(hidden, C) / np.sqrt(hidden), 0.1 * f(C))
    ls = 0.5 * f(C)
    J, T = jnp.asarray, torch.from_numpy
    want = jk.train_ln_mlp(J(x), jax.tree.map(J, ln),
                           {"fc1": {"kernel": J(fc1[0]), "bias": J(fc1[1])},
                            "fc2": {"kernel": J(fc2[0]), "bias": J(fc2[1])}}, J(ls))
    got = tk.train_ln_mlp(T(x), {k: T(v) for k, v in ln.items()},
                          {"fc1": {"weight": T(np.ascontiguousarray(fc1[0].T)), "bias": T(fc1[1])},
                           "fc2": {"weight": T(np.ascontiguousarray(fc2[0].T)), "bias": T(fc2[1])}},
                          T(ls))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ACT)


@pytest.fixture(scope="module")
def model():
    """JAX params with non-trivial norms and biases, images, JAX's loss and
    gradients on its kernel path, and the kept indices of its forward (the
    training path has no selection tap; in fp32 the two select alike)."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = jvit.ViTConfig(**CFG), tvit.ViTConfig(**CFG)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0), jcfg))
    for blk in jp["blocks"]:
        for leaf in ("norm1", "norm2"):
            blk[leaf]["scale"] = 1 + 0.1 * rng.standard_normal(160).astype(np.float32)
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * rng.standard_normal(d["bias"].shape).astype(np.float32)
    jp["cls_token"] = 0.1 * rng.standard_normal(jp["cls_token"].shape).astype(np.float32)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    jsched = jvit.normalize_schedule(SCHED, jcfg.depth)
    x = jnp.asarray(images)

    def loss(p):
        lg = jtp.vit_forward_train(p, x, jcfg, jsched, stock_impl="pallas").astype(jnp.float32)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(2), LABELS])

    jparams = jax.tree.map(jnp.asarray, jp)
    l_k, g_k = jax.jit(jax.value_and_grad(loss))(jparams)

    def forward_sel(p):
        sel = {}
        jvit.vit_forward(p, x, jcfg, jsched, "xla", _sel_tap=sel.__setitem__)
        return sel

    sel = jax.jit(forward_sel)(jparams)
    return {"tcfg": tcfg, "jp": jp, "images": images, "loss": float(l_k), "grads": g_k,
            "sel": {i: np.asarray(k) for i, k in sel.items()}}


def test_vit_h_shaped_training_matches_jax_kernel_path(model):
    """The port's kernel path (B16, B4 + selection + B5, B17 and B18 by their
    plain versions) at head_dim 80 against JAX's kernel path."""
    tp = params_from_numpy(model["jp"])
    leaves = ttrain.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    sel = {}
    logits = ttp.vit_forward_train(tp, torch.from_numpy(model["images"]), model["tcfg"], SCHED,
                                   _sel_tap=lambda i, k: sel.__setitem__(i, k.numpy()))
    loss = ttrain.cross_entropy(logits, torch.from_numpy(LABELS))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - model["loss"]) < 1e-5
    want = ttrain.param_leaves(params_from_numpy(jax.tree.map(np.asarray, model["grads"])))
    worst = max(float((a - b).abs().max() / (a.abs().max() + 1e-12)) for a, b in zip(want, grads))
    assert worst < 1e-4
    assert sorted(sel) == sorted(model["sel"]) == [1, 2]
    for i in sel:
        np.testing.assert_array_equal(sel[i], model["sel"][i])


def test_train_cli_at_the_narrow_vit_h_config(tmp_path, monkeypatch, capsys):
    """The training CLI on the kernel route (plain versions on the CPU) at
    the narrow config, two steps with the schedule: ``route: cuda``, a
    finite loss each step, the checkpoint written."""
    monkeypatch.setattr(ttrain, "get_config", lambda name: tvit.ViTConfig(**CFG))
    sched = tmp_path / "s.json"
    sched.write_text(json.dumps({str(k): v for k, v in SCHED.items()}))
    out = tmp_path / "h.msgpack"
    state = ttrain.main(["--synthetic", "--model", "vit_huge_patch14_224", "--schedule",
                         str(sched), "--steps", "2", "--batch_size", "2", "--kernels", "cuda",
                         "--device", "cpu", "--output", str(out), "--log_every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert "route: cuda" in lines
    losses = [float(l.split()[3]) for l in lines if l.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert state.step == 2 and out.is_file()
