"""The int8 attention tail of B10, B11, B13, B14 and B15 on the CPU: the
plain versions of what the card's tail computes in place of the row
quantizer (``rajni_tpu_torch/kernels/gemm.py``: ``row_absmax_plain``, each
row's absmax of the attention output as the attention kernels take it in
their epilogue, and ``gemm_s8q_plain``, proj quantizing that output as it
loads it), and the entry points that take the tail.

``gemm_s8q_plain`` must be the two-step route bit for bit (``quantize_rows``
of the attention output, then ``gemm_s8_plain``'s ``I8_RESIDUAL``), for a
bf16 (B10, B11) and an fp32 (B13-B15) attention output, dynamic and static,
with the residual contiguous (B10, B15) and gathered through the kept
indices (B11, B13, B14). B10's and B13's entry points take ``two_launch``
and on the CPU run their plain versions either way, held to the JAX Pallas
kernels in interpret mode (fp32, tests/test_torch_wholeblock.py's tolerance
and flip allowance). The wrapper ``gemm_s8q`` refuses what the kernel does
not take before it dispatches. Inputs are made from a seed with numpy, at a
narrow width.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rajni_tpu.kernels import block as jblock
from rajni_tpu.ops.pruning import select_tokens_dense as jselect
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import gemm as tgemm
from rajni_tpu_torch.kernels.math import quantize_rows, quantize_static
from rajni_tpu_torch.ops.pruning import select_tokens_dense
from tests.test_torch_wholeblock import _block, _int8_close


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, N, C, H, KEEP = 2, 29, 128, 2, 19
SCALE = (C // H) ** -0.5
STATIC = (4 / 127, 2 / 127)  # (a_qkv, a_proj)


def _proj(rng):
    """An int8 proj record with its fp32 scales and bias, and bf16 ls."""
    w = rng.integers(-127, 128, (C, C)).astype(np.int8)
    ws = ((0.5 + rng.random(C)) / (64 * np.sqrt(C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ls = torch.from_numpy((1 + 0.1 * rng.standard_normal(C)).astype(np.float32))
    return torch.from_numpy(w), torch.from_numpy(ws), torch.from_numpy(bias), ls.to(torch.bfloat16)


@pytest.mark.parametrize("gathered", [False, True], ids=["contiguous", "gathered"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_on_load_is_the_two_step_route(dtype, static, gathered):
    rng = np.random.default_rng(31)
    w, ws, bias, ls = _proj(rng)
    rows = B * (KEEP + 1 if gathered else N)
    # rows of very different magnitudes, one of them all zeros (the floor)
    o = rng.standard_normal((rows, C)).astype(np.float32) * rng.uniform(0.01, 8.0, (rows, 1))
    o[3] = 0.0
    o = torch.from_numpy(o.astype(np.float32)).to(getattr(torch, dtype))
    x = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(torch.bfloat16)
    if gathered:
        keep_idx, _ = select_tokens_dense(torch.from_numpy(rng.random((B, N)).astype(np.float32)),
                                          KEEP)
        res = dict(res=x, res_idx=keep_idx.to(torch.int32).reshape(-1), rows_out=KEEP + 1,
                   rows_in=N)
    else:
        res = dict(res=x[:, :rows // B].reshape(rows, C).contiguous())
    amax = tgemm.row_absmax_plain(o)
    # the attention kernels take it over each head's columns, then the heads
    heads = o.float().abs().reshape(rows, H, C // H).amax(dim=-1).amax(dim=-1)
    assert torch.equal(amax, heads)
    got = tgemm.gemm_s8q(o, None if static else amax, w, ws, bias, ls, **res)
    q, a = (quantize_static(o.float()), None) if static else quantize_rows(o.float())
    want = tgemm.gemm_s8_plain(q, w, ws, bias, tgemm.I8_RESIDUAL, a, None, ls, **res)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def blk():
    """One int8 block (JAX's quantize_weight records) with layer scales and
    its fp32 input."""
    rng = np.random.default_rng(33)
    jb, tb = _block(rng, C, 4 * C, with_ls=True, int8=True)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    return jb, tb, x, rng.random((B, N)).astype(np.float32)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("kernel", ["B10", "B13"])
def test_tail_entry_points_match_pallas(blk, kernel, static):
    jb, tb, x, scores = blk
    tx = torch.from_numpy(x)
    sc = STATIC if static else None
    if kernel == "B10":
        want = jblock.fused_attn_block_int8(jnp.asarray(x), jb["norm1"], jb["attn"], jb["ls1"],
                                            H, SCALE, act_scales=sc)
        got = [tblock.fused_attn_block_int8(tx, tb["norm1"], tb["attn"], tb["ls1"], H, SCALE,
                                            1e-6, sc, two_launch=two) for two in (False, True)]
    else:
        # B12's qkv (V folded under static scales), as B13 reads it
        qkv, _ = tblock.ln_qkv_int8_plain(tx, tb["norm1"], tb["attn"]["qkv"], H, 1e-6, False, sc)
        keep_idx, _ = select_tokens_dense(torch.from_numpy(scores), KEEP, torch.bool)
        jidx, sel = jselect(jnp.asarray(scores), KEEP, jnp.float32)
        np.testing.assert_array_equal(keep_idx.numpy(), np.asarray(jidx))
        a_proj = sc[1] if static else None
        want = jblock.fused_gather_sdpa_proj_residual_int8(
            jnp.asarray(qkv.numpy()), sel, jnp.asarray(x), jb["attn"]["proj"],
            jb["ls1"], H, SCALE, act_scale=a_proj)
        got = [tblock.fused_gather_sdpa_proj_residual_int8(
                   qkv, keep_idx, tx, tb["attn"]["proj"], tb["ls1"], H, SCALE, a_proj,
                   two_launch=two) for two in (False, True)]
    assert torch.equal(got[0], got[1])
    _int8_close(got[0].numpy(), np.asarray(want), f"{kernel} static={static}")


@pytest.mark.parametrize("case", ["A dtype", "amax shape", "amax dtype", "K % 128", "N % 16",
                                  "res_idx dtype"])
def test_gemm_s8q_refuses_before_dispatch(case):
    M, K, Nn = 6, 128, 64
    o = torch.zeros(M, K)
    amax = torch.zeros(M)
    w = torch.zeros(Nn, K, dtype=torch.int8)
    res, res_idx = None, None
    if case == "A dtype":
        o = o.to(torch.float16)
    elif case == "amax shape":
        amax = torch.zeros(M + 1)
    elif case == "amax dtype":
        amax = amax.double()
    elif case == "K % 128":
        o, w = torch.zeros(M, 96), torch.zeros(Nn, 96, dtype=torch.int8)
    elif case == "N % 16":
        w = torch.zeros(60, K, dtype=torch.int8)
    else:
        res, res_idx = torch.zeros(2, 5, Nn), torch.zeros(M, dtype=torch.int64)
    with pytest.raises(ValueError, match="gemm_s8"):
        tgemm.gemm_s8q(o, amax, w, torch.ones(w.shape[0]), torch.zeros(w.shape[0]), None, res,
                       res_idx, 3, 5)
