"""Drop-path and remat on the port's training path against the JAX package:
the block ops with JAX's masks against ``_stock_block_op`` and
``_pruned_block_op``, the whole training forward with JAX's masks (fold_in
per block, split, bernoulli) against ``vit_forward_train(..., drop_path,
rng)``, and remat, whose gradients equal those without it bit for bit
(tests/test_torch_train_variants.py holds the plain route's drop-path to
``vit_forward(impl="xla")``).

The narrow config is tests/test_torch_train.py's (C=128, 2 heads, 64 px,
depth 6, batch 2), JAX's kernels in interpret mode, the port's wrappers on
their plain versions (CPU tensors). Tolerances are that file's: rtol 1e-4 /
atol 1e-5 on the activations, the loss within 1e-5 and the worst relative
gradient within 1e-4 against JAX's kernel path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.models import train_path as jtp
from rajni_tpu.models import vit as jvit
from rajni_tpu_torch import params_from_numpy
from rajni_tpu_torch.params.from_jax import params_to_numpy
from rajni_tpu_torch import train as ttrain
from rajni_tpu_torch.models import train_path as ttp
from rajni_tpu_torch.models import vit as tvit

ACT = dict(rtol=1e-4, atol=1e-5)
CFG = dict(img_size=64, patch_size=16, embed_dim=128, depth=6, num_heads=2, num_classes=10,
           use_layer_scale=True)
SCHED = {"3": {"keep_ratio": 0.7, "update": True},
         "4": {"keep_ratio": 0.7, "update": False},
         "5": {"keep_ratio": 0.6, "update": True}}
LABELS = np.array([3, 7])
RATE = 0.6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    jcfg = jvit.ViTConfig(**CFG)
    jp = params_to_numpy(tvit.init_params(torch.Generator().manual_seed(0), tvit.ViTConfig(**CFG)))
    C = CFG["embed_dim"]
    for blk in jp["blocks"]:
        for d in (blk["attn"]["qkv"], blk["attn"]["proj"], blk["mlp"]["fc1"], blk["mlp"]["fc2"]):
            d["bias"] = 0.05 * rng.standard_normal(d["bias"].shape).astype(np.float32)
        blk["ls1"] = 0.5 * rng.standard_normal(C).astype(np.float32)
        blk["ls2"] = 0.5 * rng.standard_normal(C).astype(np.float32)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    return {"jcfg": jcfg, "tcfg": tvit.ViTConfig(**CFG), "jp": jp, "images": images,
            "jsched": jvit.normalize_schedule(SCHED, jcfg.depth)}


def _jax_masks(rng, depth, batch):
    """JAX's key schedule (``train_path.py:vit_forward_train``): per block
    with a rate, ``split(fold_in(rng, i))`` and one ``_dp_mask`` a branch."""
    out = []
    for i, r in enumerate(jvit.drop_path_rates(RATE, depth)):
        if r > 0.0:
            k = jax.random.split(jax.random.fold_in(rng, i))
            out.append(tuple(jtp._dp_mask(k[j], r, batch, jnp.float32) for j in range(2)))
        else:
            out.append(None)
    return out


def _port_masks(jmasks):
    return [None if m is None else tuple(torch.from_numpy(np.array(a)) for a in m)
            for m in jmasks]


def _port_block(jblock) -> dict:
    dense = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    tree = {"patch_embed": dense, "cls_token": np.zeros((1, 1, 1), np.float32),
            "pos_embed": np.zeros((1, 1, 1), np.float32), "head": dense,
            "blocks": [jax.tree.map(np.asarray, jblock)]}
    return params_from_numpy(tree)["blocks"][0]


def _rel(want, got) -> float:
    want = torch.as_tensor(np.array(want))
    return float((want - got).abs().max() / (want.abs().max() + 1e-12))


def test_drop_path_rates_match_jax():
    for rate, depth in ((0.1, 12), (0.6, 6), (0.3, 1)):
        assert tvit.drop_path_rates(rate, depth) == jvit.drop_path_rates(rate, depth)


@pytest.mark.parametrize("op", ["stock", "pruned"])
def test_block_ops_with_masks_match_jax(model, op):
    """One block op with JAX's masks (a dropped and a kept sample in each
    branch): forward, and the gradients of x and every leaf for a random
    cotangent, against JAX's op."""
    rng = np.random.default_rng(1)
    jb = jax.tree.map(jnp.asarray, model["jp"]["blocks"][4])
    n, C, keep = 17, 128, 11
    x = (0.5 * rng.standard_normal((2, n, C))).astype(np.float32)
    m1, m2 = (np.array([0.0, 1 / 0.6], np.float32).reshape(2, 1, 1),
              np.array([1 / 0.6, 0.0], np.float32).reshape(2, 1, 1))
    dp = (jnp.asarray(m1), jnp.asarray(m2))
    scale = 64 ** -0.5
    k = n if op == "stock" else keep + 1
    g = rng.standard_normal((2, k, C)).astype(np.float32)
    if op == "stock":
        def jfn(b, xx):
            return jtp._stock_block_op((2, scale, 1e-6), b, xx, dp)
    else:
        def jfn(b, xx):
            return jtp._pruned_block_op((2, scale, 1e-6, keep, True), b, xx, None, dp)[0]
    @jax.jit
    def fwd_bwd(b, xx, gg):
        y, vjp = jax.vjp(jfn, b, xx)
        return y, *vjp(gg)

    y_j, d_blk, d_x = fwd_bwd(jb, jnp.asarray(x), jnp.asarray(g))

    blk = _port_block(jb)
    paths = ttp._paths(blk)
    leaves = [t.requires_grad_(True) for t in ttp._flatten(blk, paths)]
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = (torch.from_numpy(m1), torch.from_numpy(m2))
    if op == "stock":
        y = ttp._StockBlock.apply((2, scale, 1e-6, paths), xt, *mt, *leaves)
    else:
        y = ttp._PrunedBlock.apply((2, scale, 1e-6, keep, True, paths), xt, None, *mt, *leaves)[0]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **ACT)
    grads = torch.autograd.grad(y, [xt, *leaves], torch.from_numpy(g))
    assert _rel(d_x, grads[0]) < 1e-4
    want = ttp._flatten(_port_block(d_blk), paths)
    assert max(_rel(w.numpy(), t) for w, t in zip(want, grads[1:])) < 1e-4


def _loss_grads(fwd, params):
    leaves = ttrain.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttrain.cross_entropy(fwd(params), torch.from_numpy(LABELS))
    return loss.item(), torch.autograd.grad(loss, leaves)


def _jax_loss_grads(fwd, params):
    def f(p):
        lg = fwd(p).astype(jnp.float32)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]), LABELS])
    loss, g = jax.jit(jax.value_and_grad(f))(jax.tree.map(jnp.asarray, params))
    return float(loss), ttrain.param_leaves(params_from_numpy(jax.tree.map(np.asarray, g)))


def test_training_forward_with_jax_masks_matches_jax(model):
    """The kernel route (plain versions) with JAX's masks against JAX's
    ``vit_forward_train(..., drop_path, rng)``."""
    rng = jax.random.key(7)
    jm = _jax_masks(rng, CFG["depth"], 2)
    flat = np.concatenate([np.asarray(a).ravel() for m in jm if m for a in m])
    assert (flat == 0).any() and (flat > 1).any()  # some samples dropped, some kept
    x_j, x_t = jnp.asarray(model["images"]), torch.from_numpy(model["images"])
    masks = _port_masks(jm)
    l_k, g_k = _jax_loss_grads(lambda p: jtp.vit_forward_train(
        p, x_j, model["jcfg"], model["jsched"], stock_impl="pallas", drop_path=RATE, rng=rng),
        model["jp"])
    loss, grads = _loss_grads(lambda p: ttp.vit_forward_train(
        p, x_t, model["tcfg"], SCHED, dp_masks=masks), params_from_numpy(model["jp"]))
    assert abs(loss - l_k) < 1e-5
    assert max(_rel(a, b) for a, b in zip(g_k, grads)) < 1e-4


@pytest.mark.parametrize("route", ["kernels", "torch"])
def test_remat_gradients_are_bitwise(model, route):
    """Remat re-runs the same forward inside the backward: the same loss and
    the same gradients, bit for bit, with drop-path on; the recompute draws
    nothing (the global RNG is not advanced)."""
    x = torch.from_numpy(model["images"])
    masks = ttrain.step_drop_path_masks(3, 0, RATE, CFG["depth"], 2, torch.float32, "cpu")

    def fwd(remat):
        if route == "kernels":
            return lambda p: ttp.vit_forward_train(p, x, model["tcfg"], SCHED, remat=remat,
                                                   dp_masks=masks)
        return lambda p: tvit.vit_forward(p, x, model["tcfg"], SCHED, "torch", remat=remat,
                                          dp_masks=masks)

    loss, grads = _loss_grads(fwd(False), params_from_numpy(model["jp"]))
    state = torch.get_rng_state()
    loss_r, grads_r = _loss_grads(fwd(True), params_from_numpy(model["jp"]))
    assert torch.equal(state, torch.get_rng_state())
    assert loss == loss_r
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


def test_drop_path_masks_follow_the_key_schedule():
    """Each block's masks are a pure function of (seed, step, block): the same
    key draws the same masks, another step others; rate 0 blocks draw none."""
    a = ttrain.step_drop_path_masks(1, 4, 0.5, 6, 64, torch.float32, "cpu")
    b = ttrain.step_drop_path_masks(1, 4, 0.5, 6, 64, torch.float32, "cpu")
    c = ttrain.step_drop_path_masks(1, 5, 0.5, 6, 64, torch.float32, "cpu")
    assert a[0] is None and all(m is not None for m in a[1:])
    assert all(torch.equal(p, q) for m, n in zip(a[1:], b[1:]) for p, q in zip(m, n))
    assert any(not torch.equal(p, q) for m, n in zip(a[1:], c[1:]) for p, q in zip(m, n))
    vals = torch.cat([t.ravel() for m in a[1:] for t in m])
    assert set(vals.unique().tolist()) <= {0.0} | {1 / (1 - r) for r in
                                                   np.float32(tvit.drop_path_rates(0.5, 6))}


def test_kernel_route_refuses_drop_path_in_inference():
    cfg = tvit.ViTConfig(**CFG)
    params = tvit.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(2, 64, 64, 3)
    masks = ttrain.step_drop_path_masks(0, 0, 0.1, cfg.depth, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="ops path only"):
        tvit.vit_forward(params, x, cfg, SCHED, "cuda", drop_path=0.1)
    with pytest.raises(ValueError, match="ops path only"):
        tvit.vit_forward(params, x, cfg, SCHED, "cuda", dp_masks=masks)
    with pytest.raises(ValueError, match="needs its dp_masks"):
        tvit.vit_forward(params, x, cfg, SCHED, "torch", drop_path=0.1)
