"""The GEMM of K2 and K3 (``rajni_tpu_torch/kernels/gemm.py``) on the CPU.

``gemm_plain`` is the reference that ``chip_smoke.py`` holds the Hopper GEMM
to at each product's shapes. These tests hold that it is the same function
that the plain versions of K2 and K3 compute (exactly: the same arithmetic in
the same order), and those plain versions are held to the JAX Pallas kernels
(here too, once, and in ``tests/test_torch_kernels.py``). They also hold that
the wrapper refuses what the kernel does not take before it dispatches, on
any device. Inputs are made from a seed with numpy, at a narrow width (C=128,
hidden 512, a few rows).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rajni_tpu.kernels import mlp as jmlp
from rajni_tpu_torch.kernels import block as tblock
from rajni_tpu_torch.kernels import gemm as tgemm
from rajni_tpu_torch.kernels import mlp as tmlp

B, N, C, H, HIDDEN = 2, 13, 128, 2, 512
SCALE = (C // H) ** -0.5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lin(rng, fo, fi):
    return {"weight": rng.standard_normal((fo, fi)).astype(np.float32) / np.sqrt(fi),
            "bias": 0.1 * rng.standard_normal(fo).astype(np.float32)}


def _norm(rng):
    return {"scale": 1 + 0.1 * rng.standard_normal(C).astype(np.float32),
            "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}


def _torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


def _ln(x, p, eps=1e-6):
    """LayerNorm as the plain versions take it (fp32 statistics, the normed
    row rounded to the activation dtype)."""
    return tmlp._layer_norm_f32(x.float(), p["scale"], p["bias"], eps).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("add_residual", [True, False])
def test_k3_plain_is_ln_then_two_gemms(rng, dtype, with_ls, add_residual):
    dt = DTYPES[dtype]
    norm = _torch(_norm(rng), dt)
    mlp = {"fc1": _torch(_lin(rng, HIDDEN, C), dt), "fc2": _torch(_lin(rng, C, HIDDEN), dt)}
    ls = _torch(0.5 * rng.standard_normal(C).astype(np.float32), dt) if with_ls else None
    x = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(dt)
    want = tmlp.ln_mlp_residual_plain(x, norm, mlp, ls, 1e-6, add_residual)
    h = tgemm.gemm_plain(_ln(x, norm), mlp["fc1"]["weight"], mlp["fc1"]["bias"], tgemm.EPI_GELU)
    got = tgemm.gemm_plain(h, mlp["fc2"]["weight"], mlp["fc2"]["bias"], tgemm.EPI_RESIDUAL, ls,
                           x if add_residual else None)
    assert torch.equal(got, want)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(tgemm.gemm(h, mlp["fc2"]["weight"], mlp["fc2"]["bias"],
                                  tgemm.EPI_RESIDUAL, ls, x if add_residual else None), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_ls", [False, True])
def test_k2_plain_products_are_gemms(rng, dtype, with_ls):
    dt = DTYPES[dtype]
    norm = _torch(_norm(rng), dt)
    attn = {"qkv": _torch(_lin(rng, 3 * C, C), dt), "proj": _torch(_lin(rng, C, C), dt)}
    ls = _torch(0.5 * rng.standard_normal(C).astype(np.float32), dt) if with_ls else None
    x = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(dt)
    out, qkv = tblock.attn_block_qkv_plain(x, norm, attn, ls, H, SCALE)
    assert torch.equal(
        tgemm.gemm_plain(_ln(x, norm), attn["qkv"]["weight"], attn["qkv"]["bias"],
                         tgemm.EPI_BIAS), qkv)
    a = tblock._mha(qkv, H, SCALE, x.dtype)
    assert torch.equal(
        tgemm.gemm_plain(a, attn["proj"]["weight"], attn["proj"]["bias"], tgemm.EPI_RESIDUAL,
                         ls, x), out)


def test_two_gemms_match_pallas_mlp(rng):
    """LN -> gemm_plain(EPI_GELU) -> gemm_plain(EPI_RESIDUAL) against the JAX
    kernel K3 (interpret mode on the CPU), fp32, at the tolerances of
    tests/test_torch_kernels.py."""
    norm, fc1, fc2 = _norm(rng), _lin(rng, HIDDEN, C), _lin(rng, C, HIDDEN)
    ls = (0.5 * rng.standard_normal(C)).astype(np.float32)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    jm = {"fc1": {"kernel": jnp.asarray(fc1["weight"].T), "bias": jnp.asarray(fc1["bias"])},
          "fc2": {"kernel": jnp.asarray(fc2["weight"].T), "bias": jnp.asarray(fc2["bias"])}}
    want = jmlp.fused_ln_mlp_residual(jnp.asarray(x), {k: jnp.asarray(v) for k, v in norm.items()},
                                      jm, jnp.asarray(ls), 1e-6, True)
    tx, tn = torch.from_numpy(x), _torch(norm, torch.float32)
    h = tgemm.gemm_plain(_ln(tx, tn), torch.from_numpy(fc1["weight"]),
                         torch.from_numpy(fc1["bias"]), tgemm.EPI_GELU)
    got = tgemm.gemm_plain(h, torch.from_numpy(fc2["weight"]), torch.from_numpy(fc2["bias"]),
                           tgemm.EPI_RESIDUAL, torch.from_numpy(ls), tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["K % 64", "N % 8", "EPI_GELU_SAVE", "w shape", "res shape",
                                  "ls without EPI_RESIDUAL"])
def test_gemm_refuses_before_dispatch(device, case):
    M, K, Nn, epi = 5, 128, 64, tgemm.EPI_RESIDUAL
    ls = res = None
    w_shape = None
    if case == "K % 64":
        K = 96
    elif case == "N % 8":
        Nn = 60
    elif case == "EPI_GELU_SAVE":
        epi = tgemm.EPI_GELU_SAVE
    elif case == "w shape":
        w_shape = (Nn, K + 64)
    elif case == "res shape":
        res = torch.zeros(M + 1, Nn, device=device)
    else:
        epi, ls = tgemm.EPI_BIAS, torch.ones(Nn, device=device)
    a = torch.zeros(M, K, device=device)
    w = torch.zeros(w_shape or (Nn, K), device=device)
    with pytest.raises(ValueError, match="gemm"):
        tgemm.gemm(a, w, torch.zeros(Nn, device=device), epi, ls, res)


def test_gemm_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: it never runs
    the plain version on a non-CPU tensor."""
    a = torch.empty(5, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgemm.gemm(a, torch.empty(64, 128, device="meta"), torch.empty(64, device="meta"),
                   tgemm.EPI_BIAS)
