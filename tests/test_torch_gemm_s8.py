"""The int8 GEMM of B9-B15 (``rajni_tpu_torch/kernels/gemm.py``:
``gemm_s8_plain``, ``quant_groups_plain``, ``gelu_quant_plain``) on the CPU.

``gemm_s8_plain`` and ``gelu_quant_plain`` are the references that
``chip_smoke.py`` holds the wgmma s8 GEMM and fc1's quantized GELU to on the
card, bit for bit where the kernel is exact. These tests hold that they are
the same functions, bit for bit, as the products, epilogues and h quantizer
inside the plain versions of B9 (``kernels/mlp.py:_ln_mlp_int8``), B15
(``kernels/wholeblock.py:block_full_int8_plain``) and B13 (the gathered
residual), which tests/test_torch_int8_split.py and
tests/test_torch_wholeblock.py hold to the JAX Pallas kernels; once here too,
the chain of plain GEMMs against JAX's B9 (interpret mode, fp32, with
test_torch_wholeblock.py's tolerance and flip allowance). They also hold that
the wrappers refuse what the kernel does not take before they dispatch, on
any device. Inputs are made from a seed with numpy, at a narrow width (C=128,
hidden 512, 2 heads, a few rows).
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
from rajni_tpu_torch.kernels import wholeblock as twb
from rajni_tpu_torch.kernels.math import quantize_rows, quantize_static
from rajni_tpu_torch.ops.pruning import select_tokens_dense
from tests.test_torch_wholeblock import _block, _int8_close


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, N, C, H, HIDDEN, KEEP = 2, 13, 128, 2, 512, 8
SCALE = (C // H) ** -0.5
STATIC = (4 / 127, 2 / 127, 4 / 127, 3 / 127)  # (a_qkv, a_proj, a_fc1, a_fc2)


@pytest.fixture(scope="module")
def blk():
    """One int8 block with layer scales (JAX's quantize_weight records) and a
    bf16 input, the kernels' activation dtype."""
    rng = np.random.default_rng(21)
    jb, tb = _block(rng, C, HIDDEN, with_ls=True, int8=True)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    return jb, tb, x


def _quant(y32, static: bool):
    """The activation quantizer of the plain versions: ``(q, a)``, a None
    under static scales (folded upstream)."""
    return (quantize_static(y32), None) if static else quantize_rows(y32)


def _mlp_chain(x, mlp, ops, ls, hc: int, out_dtype=torch.bfloat16):
    """B9's MLP on rows x as the kernel runs it: LN2 quantized, fc1 with its
    GELU quantized per hc group, fc2 grouped over hc with the residual."""
    static = ops["sinv"] is not None
    q, a = _quant(tmlp._layer_norm_int8(x.float(), ops["ln2s"], ops["ln2b"], 1e-6), static)
    hq, hs = tgemm.gelu_quant_plain(q, mlp["fc1"]["weight"]["int8"], ops["s1"], ops["b1"], hc, a,
                                    ops["sinv"])
    return tgemm.gemm_s8_plain(hq, mlp["fc2"]["weight"]["int8"], ops["s2"], ops["b2"],
                               tgemm.I8_RESIDUAL, hs, hc, ls, x, out_dtype=out_dtype)


@pytest.mark.parametrize("hc", [HIDDEN, HIDDEN // 2], ids=["ungrouped", "hc=hidden/2"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_s8_plain_is_b9(blk, monkeypatch, static, hc):
    """fc1 to its GELU output, the h quantizer per hc chunk, and fc2 (grouped
    where hc < hidden) are _ln_mlp_int8's own, bit for bit."""
    _, tb, x = blk
    x = torch.from_numpy(x).to(torch.bfloat16)
    mlp, ls = tb["mlp"], tb["ls2"].to(torch.bfloat16)
    ops = tmlp.int8_mlp_operands(tb["norm2"], mlp, STATIC[2:] if static else None)
    seen = {"gelu": [], "quant": []}

    def spy(name, fn):
        def wrapped(*args):
            out = fn(*args)
            seen[name].append(out)
            return out
        return wrapped

    monkeypatch.setattr(tmlp, "gelu_fast", spy("gelu", tmlp.gelu_fast))
    qname = "quantize_static" if static else "quantize_rows"
    monkeypatch.setattr(tmlp, qname, spy("quant", getattr(tmlp, qname)))
    want = tmlp._ln_mlp_int8(x, mlp, ops, ls, hc, 1e-6)
    monkeypatch.undo()

    q, a = _quant(tmlp._layer_norm_int8(x.float(), ops["ln2s"], ops["ln2b"], 1e-6), static)
    w1 = mlp["fc1"]["weight"]["int8"]
    h = tgemm.gemm_s8_plain(q, w1, ops["s1"], ops["b1"], tgemm.I8_GELU, a)
    assert torch.equal(h, torch.cat(seen["gelu"], dim=-1))
    hq, hs = tgemm.gelu_quant_plain(q, w1, ops["s1"], ops["b1"], hc, a, ops["sinv"])
    chunks = seen["quant"][1:]  # the first quantizes LN2's output
    if static:
        assert hs is None
        assert torch.equal(hq, torch.cat(chunks, dim=-1))
    else:
        assert torch.equal(hq, torch.cat([c[0] for c in chunks], dim=-1))
        assert torch.equal(hs, torch.cat([c[1] for c in chunks], dim=-1))
    assert torch.equal(_mlp_chain(x, mlp, ops, ls, hc), want)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_s8_plain_is_b15(blk, static):
    """qkv, proj with the residual, and the MLP at the plan's hc (hidden/2:
    fc2 grouped) rebuild block_full_int8_plain bit for bit."""
    _, tb, x = blk
    x = torch.from_numpy(x).to(torch.bfloat16)
    blk_ = {**tb, "ls1": tb["ls1"].to(torch.bfloat16), "ls2": tb["ls2"].to(torch.bfloat16)}
    scales = STATIC if static else None
    hc = twb._block_full_int8_plan(N, C, HIDDEN, 2)[1]
    assert hc == HIDDEN // 2
    ops = twb.int8_operands(blk_, scales)
    want = twb.block_full_int8_plain(x, blk_, H, SCALE, 1e-6, scales)

    a_, m_ = blk_["attn"], blk_["mlp"]
    q, a = _quant(tmlp._layer_norm_int8(x.float(), ops["ln1s"], ops["ln1b"], 1e-6), static)
    qkv = tgemm.gemm_s8_plain(q, a_["qkv"]["weight"]["int8"], ops["sqkv"], ops["bqkv"],
                              tgemm.I8_BIAS, a)
    qa, aa = _quant(tblock._mha(qkv, H, SCALE, torch.float32), static)
    mid = tgemm.gemm_s8_plain(qa, a_["proj"]["weight"]["int8"], ops["sproj"], ops["bproj"],
                              tgemm.I8_RESIDUAL, aa, None, blk_["ls1"], x)
    assert torch.equal(_mlp_chain(mid, m_, ops, blk_["ls2"], hc), want)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_s8_plain_gathered_residual_is_b13(blk, static):
    """proj with the residual rows of x read through the kept indices is
    B13's plain version, bit for bit."""
    _, tb, x = blk
    rng = np.random.default_rng(5)
    x = torch.from_numpy(x).to(torch.bfloat16)
    attn, ls = tb["attn"], tb["ls1"].to(torch.bfloat16)
    qkv, _ = tblock.ln_qkv_int8_plain(x, tb["norm1"], attn["qkv"], H, 1e-6, False,
                                      STATIC[:2] if static else None)
    keep_idx, _ = select_tokens_dense(torch.from_numpy(rng.random((B, N)).astype(np.float32)),
                                      KEEP)
    a_proj = STATIC[1] if static else None
    want = tblock.gather_sdpa_proj_residual_int8_plain(qkv, keep_idx, x, attn["proj"], ls, H,
                                                       SCALE, a_proj)
    att = tblock._mha(torch.take_along_dim(qkv, keep_idx[..., None], dim=1), H, SCALE,
                      torch.float32)
    qa, aa = _quant(att, static)
    ops = tblock._int8_proj_operands(attn["proj"], a_proj)
    got = tgemm.gemm_s8_plain(qa, attn["proj"]["weight"]["int8"], ops["sproj"], ops["bproj"],
                              tgemm.I8_RESIDUAL, aa, None, ls, x,
                              keep_idx.to(torch.int32).contiguous(), KEEP + 1, N)
    assert torch.equal(got, want)


def test_s8_chain_matches_pallas_b9(blk):
    """The chain of plain int8 GEMMs against the JAX kernel B9 (interpret
    mode, dynamic, hc = hidden at this width), fp32."""
    jb, tb, x = blk
    assert jmlp._hidden_chunk(C, HIDDEN, 1) == HIDDEN
    want = jmlp.fused_ln_mlp_residual_int8(jnp.asarray(x), jb["norm2"], jb["mlp"], jb["ls2"])
    ops = tmlp.int8_mlp_operands(tb["norm2"], tb["mlp"])
    got = _mlp_chain(torch.from_numpy(x), tb["mlp"], ops, tb["ls2"], HIDDEN, torch.float32)
    _int8_close(got.numpy(), np.asarray(want), "B9 from gemm_s8_plain")


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["K % 128", "N % 16", "group_k", "grouped I8_BIAS", "w shape",
                                  "a shape", "ls without I8_RESIDUAL", "res_idx dtype",
                                  "unknown epilogue"])
def test_gemm_s8_refuses_before_dispatch(device, case):
    M, K, Nn, epi, gk = 5, 256, 64, tgemm.I8_RESIDUAL, None
    a = ls = res = res_idx = None
    w_shape = None
    if case == "K % 128":
        K = 192
    elif case == "N % 16":
        Nn = 56
    elif case == "group_k":
        gk = 192
    elif case == "grouped I8_BIAS":
        epi, gk = tgemm.I8_BIAS, 128
    elif case == "w shape":
        w_shape = (Nn, K + 128)
    elif case == "a shape":
        a = torch.zeros(M, 2, device=device)  # one group: [M, 1]
    elif case == "ls without I8_RESIDUAL":
        epi, ls = tgemm.I8_BIAS, torch.ones(Nn, device=device)
    elif case == "res_idx dtype":
        res = torch.zeros(M, Nn, device=device)
        res_idx = torch.zeros(M, dtype=torch.int64, device=device)
    else:
        epi = 3
    q = torch.zeros(M, K, dtype=torch.int8, device=device)
    w = torch.zeros(w_shape or (Nn, K), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="gemm_s8"):
        tgemm.gemm_s8(q, w, torch.ones(Nn, device=device), torch.zeros(Nn, device=device), epi,
                      a, gk, ls, res, res_idx)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["hc % 128", "N % hc", "sinv with a"])
def test_gelu_quant_refuses_before_dispatch(device, case):
    M, K, Nn, hc = 5, 128, 512, 256
    a = sinv = None
    if case == "hc % 128":
        hc = 192
    elif case == "N % hc":
        Nn = 384
    else:
        a, sinv = torch.ones(M, 1, device=device), torch.ones(Nn, device=device)
    q = torch.zeros(M, K, dtype=torch.int8, device=device)
    w = torch.zeros(Nn, K, dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="gelu_quant"):
        tgemm.gelu_quant(q, w, torch.ones(Nn, device=device), torch.zeros(Nn, device=device), hc,
                         a, sinv)


def test_s8_wrappers_refuse_other_devices():
    """Off the CPU the wrappers launch the kernel or raise: they never run the
    plain version on a non-CPU tensor."""
    q = torch.empty(5, 128, dtype=torch.int8, device="meta")
    w = torch.empty(128, 128, dtype=torch.int8, device="meta")
    v = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgemm.gemm_s8(q, w, v, v, tgemm.I8_BIAS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgemm.gelu_quant(q, w, v, v, 128)
