"""The PyTorch port's schedule and ops against the JAX package.

Inputs are drawn with numpy and fed to both packages; everything compares in
fp32 on the CPU. Tolerances follow tests/test_kernels.py: rtol 1e-4 /
atol 1e-5 for activations, atol 1e-6 for scores; selections exactly.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rajni_tpu.ops import attention as jattn
from rajni_tpu.ops import importance as jimp
from rajni_tpu.ops import pruning as jprune
from rajni_tpu_torch.ops import attention as tattn
from rajni_tpu_torch.ops import importance as timp
from rajni_tpu_torch.ops import pruning as tprune
from rajni_tpu_torch.utils import schedule as tsched


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ACT = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize(
    "n,schedule,want",
    [
        (197, tsched.REFERENCE_SCHEDULE,
         [197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120]),
        (577, tsched.REFERENCE_SCHEDULE,
         [577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356]),
        (197, {3: {"keep_ratio": 0.88}, 4: {"keep_ratio": 0.88},
               7: {"keep_ratio": 0.8}, 8: {"keep_ratio": 0.72}},
         [197, 197, 197, 197, 173, 152, 152, 152, 121, 87, 87, 87]),
    ],
)
def test_token_count_trace_matches_survey(n, schedule, want):
    sched = tsched.normalize_schedule(schedule, 12)
    assert tsched.token_count_trace(n, sched) == want


def test_schedule_string_keys_and_load(tmp_path):
    str_keys = {str(k): v for k, v in tsched.REFERENCE_SCHEDULE.items()}
    a = tsched.normalize_schedule(tsched.REFERENCE_SCHEDULE, 12)
    assert tsched.normalize_schedule(str_keys, 12) == a
    path = tmp_path / "s.json"
    path.write_text(json.dumps(str_keys))
    assert tsched.load_schedule(str(path), 12) == a
    assert a[3] == tsched.PruneSpec(0.95, False)
    assert tsched.normalize_schedule({"1": {"keep_ratio": 0.5}}, 2)[1].update
    assert tsched.schedule_to_dict(a) == tsched.REFERENCE_SCHEDULE
    with pytest.raises(ValueError):
        tsched.normalize_schedule({12: {"keep_ratio": 0.5}}, 12)
    with pytest.raises(ValueError):
        tsched.normalize_schedule({0: {"keep_ratio": 1.5}}, 12)
    with pytest.raises(ValueError):
        tsched.normalize_schedule((None,), 12)


def test_keep_count_matches_jax():
    for ratio in (0.01, 0.3, 0.5, 0.72, 0.85, 0.88, 0.95, 1.0):
        for n in (2, 17, 65, 120, 197, 577):
            assert tprune.keep_count(ratio, n) == jprune.keep_count(ratio, n)


def test_compute_importance_matches_jax(rng):
    qkv = rng.standard_normal((3, 29, 3 * 32)).astype(np.float32)
    want = np.asarray(jimp.compute_importance(jnp.asarray(qkv), 4))
    got = timp.compute_importance(_t(qkv), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_selection_matches_lax_top_k(rng, ties):
    """Ties must break to the lower index, exactly as lax.top_k orders them."""
    scores = rng.random((4, 41)).astype(np.float32)
    if ties:
        # few distinct positive levels: many exact ties. (Importance scores
        # are positive; lax.top_k would order -0.0 below +0.0, which no
        # comparison-based selector does.)
        scores = (rng.integers(1, 6, (4, 41)) / 4).astype(np.float32)
    keep = 17
    want = np.asarray(jprune.select_tokens(jnp.asarray(scores), keep))
    got = tprune.select_tokens(_t(scores), keep).numpy()
    np.testing.assert_array_equal(got, want)
    want_d, want_sel = jprune.select_tokens_dense(jnp.asarray(scores), keep)
    got_d, got_sel = tprune.select_tokens_dense(_t(scores), keep)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_d.numpy(), want)
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))


def test_onehot_gather_is_exact(rng):
    x = _t(rng.standard_normal((2, 13, 8)))
    idx = tprune.select_tokens(_t(rng.standard_normal((2, 13))), 5)
    sel = tprune.onehot_matrix(idx, 13, torch.float32)
    np.testing.assert_array_equal(
        tprune.gather_tokens_matmul(x, sel).numpy(), tprune.gather_tokens(x, idx).numpy()
    )


def _attn_params(rng, C):
    jp = {
        "qkv": {"kernel": rng.standard_normal((C, 3 * C)).astype(np.float32) * 0.2,
                "bias": rng.standard_normal(3 * C).astype(np.float32) * 0.1},
        "proj": {"kernel": rng.standard_normal((C, C)).astype(np.float32) * 0.2,
                 "bias": rng.standard_normal(C).astype(np.float32) * 0.1},
    }
    tp = {k: {"weight": _t(v["kernel"].T.copy()), "bias": _t(v["bias"])} for k, v in jp.items()}
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}, tp


def test_attention_matches_jax(rng):
    C, H = 32, 4
    jp, tp = _attn_params(rng, C)
    x = rng.standard_normal((2, 19, C)).astype(np.float32)
    want = np.asarray(jattn.attention(jnp.asarray(x), jp, H, (C // H) ** -0.5))
    got = tattn.attention(_t(x), tp, H, (C // H) ** -0.5).numpy()
    np.testing.assert_allclose(got, want, **ACT)


@pytest.mark.parametrize("update", [True, False])
def test_pruned_attention_matches_jax(rng, update):
    C, H, N, keep = 32, 4, 23, 11
    jp, tp = _attn_params(rng, C)
    x = rng.standard_normal((3, N, C)).astype(np.float32)
    prev = rng.random((3, N)).astype(np.float32)
    scale = (C // H) ** -0.5
    j_out, j_idx, j_ns = jattn.pruned_attention(
        jnp.asarray(x), jp, H, scale, keep, update, jnp.asarray(prev)
    )
    t_out, t_idx, t_ns = tattn.pruned_attention(_t(x), tp, H, scale, keep, update, _t(prev))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_ns.numpy(), np.asarray(j_ns), atol=1e-6)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **ACT)
