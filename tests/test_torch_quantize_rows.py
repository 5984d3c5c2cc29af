"""The port's per-row int8 quantizer against the JAX package's, bit for bit.

``rajni_tpu_torch/kernels/math.py:quantize_rows`` must give the int8 values
and row scales of ``rajni_tpu/kernels/math.py:quantize_rows``, which takes
the multiplier ``127 / absmax`` as one division, as the CUDA kernels do
(``csrc/int8.cuh``, ``__fdiv_rn(127.f, amax)``). PyTorch takes ``127.0 /
tensor`` as ``127 · (1 / tensor)``, two roundings, which differs from the
division in about a quarter of fp32 values; case ``rounding-edge`` is made of
rows whose absmax lies in that set, with elements placed where the two
multipliers round to neighbouring integers, so a port that multiplies by the
two-rounding form fails it. The other cases: random normal rows at a ViT-B
MLP width, rows of zeros (the 1e-8 floor), and bf16-rounded rows. Inputs are
made from a seed with numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rajni_tpu.kernels import math as jmath
from rajni_tpu_torch.kernels import math as tmath


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROWS, WIDTH = 512, 3072


def _edge_rows(rng) -> np.ndarray:
    """Rows ``[ROWS, WIDTH]`` whose absmax a has ``f32(127 / a) != f32(127 ·
    f32(1 / a))``, each with elements y at which ``rint(y · m)`` differs
    between the two multipliers m (the rest of the row uniform in [-a, a])."""
    a = rng.uniform(1e-3, 10.0, 20 * ROWS).astype(np.float32)
    one_div = np.float32(127.0) / a
    two_rnd = np.float32(127.0) * (np.float32(1.0) / a)
    a, m1, m2 = a[one_div != two_rnd], one_div[one_div != two_rnd], two_rnd[one_div != two_rnd]
    assert a.size >= ROWS, "too few absmax values where the two multipliers differ"
    a, m1, m2 = a[:ROWS], m1[:ROWS], m2[:ROWS]
    rows = (rng.uniform(-1.0, 1.0, (ROWS, WIDTH)) * a[:, None]).astype(np.float32)
    rows[:, 0] = a
    # candidates near each half-integer k + 0.5 (k < 126): y = (k + 0.5) / m
    # and its fp32 neighbours; keep those that round apart under m1 and m2
    k = np.arange(126, dtype=np.float32) + np.float32(0.5)
    base = (k[None, :] / ((m1[:, None] + m2[:, None]) / 2)).astype(np.float32)
    found = 0
    for step in range(-4, 5):
        y = base
        for _ in range(abs(step)):
            y = np.nextafter(y, np.float32(np.inf if step > 0 else -np.inf)).astype(np.float32)
        apart = np.rint(y * m1[:, None]) != np.rint(y * m2[:, None])
        for r, c in zip(*np.nonzero(apart)):
            col = 1 + (found % (WIDTH - 1))
            rows[r, col] = -y[r, c] if found % 2 else y[r, c]
            found += 1
    assert found > 0, "no element rounds apart under the two multipliers"
    return rows


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "rounding-edge":
        return _edge_rows(rng)
    if name == "normal":
        return rng.standard_normal((ROWS, WIDTH)).astype(np.float32)
    if name == "zeros":
        y = rng.standard_normal((8, 64)).astype(np.float32)
        y[::2] = 0.0
        return y
    # bf16-rounded rows, as the attention output of B10 and B11 is
    y = rng.standard_normal((ROWS, 1024)).astype(np.float32) * 3.0
    return torch.from_numpy(y).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", ["rounding-edge", "normal", "zeros", "bf16"])
def test_quantize_rows_is_jax_bit_for_bit(case):
    y = _case(case)
    want_q, want_s = jmath.quantize_rows(jnp.asarray(y))
    got_q, got_s = tmath.quantize_rows(torch.from_numpy(y))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32), np.asarray(want_s).view(np.int32))
