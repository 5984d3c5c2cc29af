"""The score kernel's widths at head_dim 64 up to C = 1280 (20 heads), on the
CPU: ``kernels/block.py:_score_fits`` takes them, as
``csrc/common.cuh:launch_score`` does (its fifth 16-byte piece a lane), and
the plain scores at C = 1280 with 20 heads of 64 match the JAX package's
``_importance_f32`` and ``compute_importance`` on the same qkv, at rtol 1e-5
/ atol 1e-6 (tests/test_torch_head_dim80.py's score tolerance). The kernel
itself runs only on the card (``chip_smoke.py``'s C5 phase).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rajni_tpu.kernels import block as jblock
from rajni_tpu.ops.importance import compute_importance
from rajni_tpu_torch.kernels import block as tblock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("N,C,H,fits", [
    (197, 1280, 20, True), (257, 1280, 20, True), (1024, 1280, 20, True),
    (197, 1024, 16, True), (197, 1280, 16, True), (197, 1344, 21, False),
    (197, 1408, 22, False), (1, 1280, 20, False), (1025, 1280, 20, False),
    (197, 1216, 19, True),
])
def test_score_fits_head_dim64_up_to_c1280(N, C, H, fits):
    assert tblock._score_fits(N, C, H) is fits


def test_c1280_20_head_scores_match_jax(rng):
    B, N, C, H = 2, 65, 1280, 20
    x = (0.5 * rng.standard_normal((B, N, C))).astype(np.float32)
    ln = {"scale": torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(np.float32)),
          "bias": torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32))}
    qkv_p = {"weight": torch.from_numpy(rng.standard_normal((3 * C, C)).astype(np.float32)
                                        / np.sqrt(C)),
             "bias": torch.from_numpy(0.1 * rng.standard_normal(3 * C).astype(np.float32))}
    qkv, got = tblock.fused_ln_qkv(torch.from_numpy(x), ln, qkv_p, H, 1e-6, True)
    assert got.shape == (B, N) and got.dtype == torch.float32
    q = qkv.numpy()
    np.testing.assert_allclose(tblock._importance_f32(qkv, H).numpy(), got.numpy(), rtol=1e-6)
    for b in range(B):
        want = jblock._importance_f32(jnp.asarray(q[b]), H)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(compute_importance(jnp.asarray(q), H)),
                               rtol=1e-5, atol=1e-6)
