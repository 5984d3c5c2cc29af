"""The int8 weight quantizer's scale (C3) and the short-row attention's plain
version and wrapper, against the JAX package.

* ``rajni_tpu_torch/quant.py:quantize_weight`` must give the int8 values and
  scales of ``rajni_tpu/quant.py:quantize_weight`` (which takes ``[in, out]``)
  bit for bit. JAX divides the absmax by 127 once; PyTorch on CUDA takes
  ``tensor / 127.0`` as a multiply by ``fl(1 / 127)``, two roundings. Case
  ``rounding-edge`` is made of rows whose absmax a has ``fl(a / 127) != a ·
  fl(1 / 127)``. On the CPU both expressions divide, so this case pins the
  repaired expression; ``chip_smoke.py``'s C3 phase is what shows it on the
  card.
* ``kernels/attention.py:attention_route_plain`` through kept indices
  against the JAX package's ``_mha`` (``rajni_tpu/kernels/block.py:130``,
  phased) applied to the one-hot gather the TPU kernels compute
  (``one_hot(idx) @ qkv``), at n = 1, 47, 64, 65 and 256 kept tokens, C =
  128, 2 heads, B = 2: in fp32 to rtol 1e-4 / atol 1e-5; in bf16 to atol 2e-2
  / rtol 2e-2 (a bf16 ulp of an output near 1 is 7.8e-3, and P's bf16
  rounding flips where the two frameworks sum in another order).
* The wrappers ``attention_route`` and ``short_attention`` refuse, before
  they dispatch, on ``cpu`` and ``meta`` tensors: the short route past 256
  tokens, head_dim != 64, an idx of the wrong dtype or shape, an unknown
  route name.

Inputs are made from a seed with numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rajni_tpu import quant as jquant
from rajni_tpu.kernels import block as jblock
from rajni_tpu_torch import quant as tquant
from rajni_tpu_torch.kernels import attention as ka


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

C, HEADS, B = 128, 2, 2
SCALE = (C // HEADS) ** -0.5


def _edge_weights(rng, rows: int = 256, width: int = 384) -> np.ndarray:
    """``[rows, width]`` weights whose rows' absmax a has ``fl(a / 127) !=
    a · fl(1 / 127)``."""
    a = rng.uniform(1e-3, 1.0, 40 * rows).astype(np.float32)
    one = a / np.float32(127.0)
    two = a * (np.float32(1.0) / np.float32(127.0))
    a = a[one != two]
    assert a.size >= rows, "too few absmax values where the two expressions differ"
    w = (rng.uniform(-1.0, 1.0, (rows, width)) * a[:rows, None]).astype(np.float32)
    w[np.arange(rows), rng.integers(0, width, rows)] = -a[:rows]
    return w


@pytest.mark.parametrize("case", ["rounding-edge", "normal"])
def test_quantize_weight_bitwise_jax(case):
    rng = np.random.default_rng(0)
    w = (_edge_weights(rng) if case == "rounding-edge"
         else (0.02 * rng.standard_normal((256, 384))).astype(np.float32))
    got = tquant.quantize_weight(torch.from_numpy(w))
    want = jquant.quantize_weight(jnp.asarray(w.T))  # [in, out]
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"])[0])
    np.testing.assert_array_equal(got["int8"].numpy(), np.asarray(want["int8"]).T)


@jax.jit
def _jax_gathered_mha(qkv, idx):
    """JAX's _mha of each image's one-hot-gathered rows, as the TPU kernels
    compute them."""
    sel = jax.nn.one_hot(idx, qkv.shape[1], dtype=qkv.dtype)
    return jax.vmap(lambda s, q: jblock._mha(s @ q, HEADS, SCALE, qkv.dtype))(sel, qkv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 47, 64, 65, 256])
def test_attention_plain_gathered_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    n_src = n + 9
    qkv = rng.standard_normal((B, n_src, 3 * C)).astype(np.float32)
    idx = np.sort(np.stack([rng.choice(n_src, n, replace=False) for _ in range(B)]), axis=1)
    tdt = getattr(torch, dtype)
    got = ka.attention_route_plain(torch.from_numpy(qkv).to(tdt),
                                   torch.from_numpy(idx.astype(np.int32)), HEADS, SCALE)
    assert got.dtype == tdt and tuple(got.shape) == (B, n, C)
    want = np.asarray(_jax_gathered_mha(jnp.asarray(qkv, getattr(jnp, dtype)), idx)
                      .astype(jnp.float32))
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_short_attention_plain_amax_and_fp32_output():
    """On the CPU short_attention is its plain version: the fp32 output is
    attention_route_plain's, and the row absmax is that of the stored output."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, 80, 3 * C)).astype(np.float32)).to(
        torch.bfloat16)
    idx = torch.from_numpy(np.sort(rng.choice(80, 70, replace=False))[None].repeat(B, 0)
                           .astype(np.int32))
    out, amax = ka.short_attention(qkv, idx, HEADS, SCALE, torch.float32, amax=True)
    assert out.dtype == torch.float32
    assert torch.equal(out, ka.attention_route_plain(qkv, idx, HEADS, SCALE, torch.float32))
    assert torch.equal(amax, out.abs().amax(dim=-1).reshape(-1))


def _refused(device: str):
    """(name, call) of each shape the wrappers must refuse before they dispatch."""
    def qkv(n, c=C):
        return torch.zeros(B, n, 3 * c, dtype=torch.bfloat16, device=device)

    def idx(n, dtype=torch.int32, shape=None):
        return torch.zeros(shape or (B, n), dtype=dtype, device=device)

    return {
        "short route past 256 tokens": lambda: ka.attention_route(
            qkv(300), idx(257), HEADS, SCALE, "short"),
        "short_attention past 256 tokens": lambda: ka.short_attention(
            qkv(257), None, HEADS, SCALE),
        "head_dim 32": lambda: ka.attention_route(qkv(64), None, 4, SCALE, "short"),
        "idx int64": lambda: ka.short_attention(qkv(64), idx(32, torch.int64), HEADS, SCALE),
        "idx of another batch": lambda: ka.attention_route(
            qkv(64), idx(32, shape=(B + 1, 32)), HEADS, SCALE, "short"),
        "idx 1-D": lambda: ka.short_attention(qkv(64), idx(32, shape=(32,)), HEADS, SCALE),
        "unknown route": lambda: ka.attention_route(qkv(64), None, HEADS, SCALE, "fast"),
    }


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_before_dispatch(device):
    for name, call in _refused(device).items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"{name}: not refused")
