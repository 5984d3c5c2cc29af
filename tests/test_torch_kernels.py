"""Plain versions of the port's kernels K1-K3 against the JAX Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them; the port's wrappers take their plain PyTorch versions because the
tensors lie on the CPU. Everything is fp32. Tolerances follow
tests/test_kernels.py: rtol 1e-4 / atol 1e-5 for activations, atol 1e-6 for
scores; kept indices must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rajni_tpu.kernels import block as jblock
from rajni_tpu.kernels import math as jmath
from rajni_tpu.kernels import mlp as jmlp
from rajni_tpu.ops.pruning import select_tokens_dense
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import math as tmath
from rajni_tpu_torch.kernels import mlp as tmlp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ACT = dict(rtol=1e-4, atol=1e-5)
B, N, C, H, HIDDEN = 2, 29, 48, 4, 192
SCALE = (C // H) ** -0.5


def _block(rng, with_ls: bool):
    """The same random block params as a JAX tree and as the port's tree."""
    def dense(fi, fo):
        return {"kernel": rng.standard_normal((fi, fo)).astype(np.float32) / np.sqrt(fi),
                "bias": rng.standard_normal(fo).astype(np.float32) * 0.1}

    def norm():
        return {"scale": 1 + 0.1 * rng.standard_normal(C).astype(np.float32),
                "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}

    jb = {"norm1": norm(), "attn": {"qkv": dense(C, 3 * C), "proj": dense(C, C)},
          "norm2": norm(), "mlp": {"fc1": dense(C, HIDDEN), "fc2": dense(HIDDEN, C)}}
    if with_ls:
        jb["ls1"] = (0.5 * rng.standard_normal(C)).astype(np.float32)
        jb["ls2"] = (0.5 * rng.standard_normal(C)).astype(np.float32)

    def conv(d):
        if isinstance(d, dict):
            if "kernel" in d:
                return {"weight": torch.from_numpy(d["kernel"].T.copy()),
                        "bias": torch.from_numpy(d["bias"])}
            return {k: conv(v) for k, v in d.items()}
        return torch.from_numpy(d)

    def to_jax(d):
        if isinstance(d, dict):
            return {k: to_jax(v) for k, v in d.items()}
        return jnp.asarray(d)

    return to_jax(jb), conv(jb)


def test_gelu_and_erf_match_jax(rng):
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    x[:4] = [-10.0, -6.0, 6.0, 10.0]
    for name in ("erf", "gelu_exact", "gelu_fast"):
        want = np.asarray(getattr(jmath, name)(jnp.asarray(x)))
        got = getattr(tmath, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("with_ls", [False, True])
def test_k3_ln_mlp_residual_matches_pallas(rng, add_residual, with_ls):
    jb, tb = _block(rng, with_ls)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    want = jmlp.fused_ln_mlp_residual(
        jnp.asarray(x), jb["norm2"], jb["mlp"], jb.get("ls2"), 1e-6, add_residual
    )
    got = tmlp.fused_ln_mlp_residual(
        torch.from_numpy(x), tb["norm2"], tb["mlp"], tb.get("ls2"), 1e-6, add_residual
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


@pytest.mark.parametrize("with_ls", [False, True])
def test_k2_attn_block_matches_pallas(rng, with_ls):
    jb, tb = _block(rng, with_ls)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    want = jblock.fused_attn_block(jnp.asarray(x), jb["norm1"], jb["attn"], jb.get("ls1"), H, SCALE)
    got = tblock.fused_attn_block(torch.from_numpy(x), tb["norm1"], tb["attn"], tb.get("ls1"), H, SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


@pytest.mark.parametrize("with_scores", [True, False])
@pytest.mark.parametrize("with_ls", [False, True])
def test_k1_pruned_attn_block_matches_pallas(rng, with_scores, with_ls):
    jb, tb = _block(rng, with_ls)
    keep = 17
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    prev = rng.random((B, N)).astype(np.float32)
    jx = jnp.asarray(x)
    want_x, want_ns = jblock.fused_pruned_attn_block(
        jx, jb["norm1"], jb["attn"], jb.get("ls1"), jnp.asarray(prev), H, keep,
        SCALE, 1e-6, with_scores,
    )
    got_x, got_ns, got_idx = tblock.fused_pruned_attn_block(
        torch.from_numpy(x), tb["norm1"], tb["attn"], tb.get("ls1"),
        torch.from_numpy(prev), H, keep, SCALE, 1e-6, with_scores,
    )
    # The Pallas kernel keeps its selection inside; recompute it from the
    # JAX scores (the LN+QKV kernel's in-pass scores, or the threaded ones).
    if with_scores:
        _, scores = jblock.fused_ln_qkv(jx, jb["norm1"], jb["attn"]["qkv"], H, 1e-6, True)
    else:
        scores = jnp.asarray(prev)
    want_idx, _ = select_tokens_dense(scores, keep)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_ns.numpy(), np.asarray(want_ns), atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **ACT)


def test_k1_threaded_ties_break_to_lower_index(rng):
    """Exact duplicate threaded scores: K1's plain route keeps the lower
    index, as lax.top_k does."""
    _, tb = _block(rng, False)
    s = (rng.integers(1, 4, (B, N)) / 4).astype(np.float32)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    keep = 11
    want, _ = select_tokens_dense(jnp.asarray(s), keep)
    want_topk = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.sort(jax.lax.top_k(jnp.asarray(s[:, 1:]), keep)[1], axis=1) + 1], axis=1)
    _, ns, idx = tblock.fused_pruned_attn_block(
        torch.from_numpy(x), tb["norm1"], tb["attn"], None, torch.from_numpy(s), H, keep,
        SCALE, 1e-6, False,
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_topk))
    np.testing.assert_array_equal(ns.numpy(), np.take_along_axis(s, idx.numpy(), axis=1))


def test_wrappers_refuse_other_devices(rng):
    """Off the CPU a wrapper launches its kernel or raises: it never runs
    the plain version on a non-CPU tensor."""
    _, tb = _block(rng, False)
    x = torch.empty(B, N, C, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmlp.fused_ln_mlp_residual(x, tb["norm2"], tb["mlp"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblock.fused_attn_block(x, tb["norm1"], tb["attn"], None, H, SCALE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblock.fused_pruned_attn_block(x, tb["norm1"], tb["attn"], None, None, H, 5, SCALE)
