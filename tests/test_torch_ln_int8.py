"""The int8 LayerNorm's plain version against the JAX package.

``rajni_tpu_torch/kernels/mlp.py:_layer_norm_int8`` sums the LayerNorm
statistics in the order of the card's ``ln_quant_kernel`` (lane chunks, then
the warp's xor butterfly), so that kernel and plain version agree bit for
bit; JAX's ``_layer_norm_f32`` (``rajni_tpu/kernels/block.py:105``) takes
``jnp.mean``. Two fp32 sums of the same terms in other orders differ by a
few ulp, so the outputs, of magnitude up to ~5 here, must agree within
rtol 1e-6 / atol 1e-6 (about 2 ulp at 4; measured: at most 9.5e-7). At the
widths no kernel takes (C > 1280, C % 8 != 0) the plain version is
``_layer_norm_f32``, whatever the shape; at C = 1280 (ViT-H/14) it is the
kernel's order with 5 chunks a lane.

Where the order does show: an LN output one ulp apart can flip an int8
quantization step, and a flipped k or v element moves a RAJNI score. B14
(``fused_pruned_block_full_int8``) at DeiT-S/16 384's first pruned block
(519 tokens kept to 467, C=384, 6 heads, bf16 as the card runs it), on the
CPU against the JAX Pallas kernel in interpret mode, must keep its rescored
``next_scores`` within ``chip_smoke.py``'s SCORE_RTOL (1e-2 relative, each
score) and its output within one int8 flip (INT8_FLIP, 0.05,
tests/test_torch_wholeblock.py) of JAX's, element by element (bf16 rounding
of the residual stream leaves more elements one ulp apart than
``_int8_close``'s 2%).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rajni_tpu.kernels import block as jblock
from rajni_tpu_torch.kernels import wholeblock as twb
from rajni_tpu_torch.kernels.mlp import _layer_norm_f32, _layer_norm_int8
from tests.test_torch_wholeblock import INT8_FLIP, _block


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SCORE_RTOL = 1e-2  # chip_smoke.py: rescored next_scores, each relative


@pytest.mark.parametrize("C", [64, 384, 1024, 1280, 1408, 100])
def test_layer_norm_int8_matches_jax(C):
    rng = np.random.default_rng(C)
    x = (3 * rng.standard_normal((256, C)) + rng.standard_normal((256, 1))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = _layer_norm_int8(*t, 1e-6)
    want = jblock._layer_norm_f32(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if C % 8 or C > 1280:
        assert torch.equal(got, _layer_norm_f32(*t, 1e-6))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_b14_rescoring_at_519_tokens_matches_pallas(static):
    N, K, C, H = 519, 467, 384, 6
    rng = np.random.default_rng(0)
    jb, tb = _block(rng, C, 4 * C, with_ls=True, int8=True)
    x = rng.standard_normal((1, N, C)).astype(np.float32)
    scales = (4 / 127, 2 / 127, 4 / 127, 3 / 127) if static else None
    scale = (C // H) ** -0.5
    want_x, want_ns = jblock.fused_pruned_block_full_int8(
        jnp.asarray(x, jnp.bfloat16), jb, None, H, K - 1, scale, 1e-6, True, act_scales=scales)
    got_x, got_ns, _ = twb.fused_pruned_block_full_int8(
        torch.from_numpy(x).to(torch.bfloat16), tb, None, H, K - 1, scale, 1e-6, True, scales)
    want_ns = np.asarray(want_ns)
    rel = np.abs(got_ns.numpy() - want_ns) / np.abs(want_ns)
    assert rel.max() <= SCORE_RTOL, rel.max()
    diff = np.abs(got_x.float().numpy() - np.asarray(want_x, np.float32))
    assert diff.max() <= INT8_FLIP, diff.max()
