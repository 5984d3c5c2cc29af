"""Carry a ``rajni_tpu`` parameter tree, given as numpy arrays, into the
port's layout.

The JAX tree stores linear kernels ``[in, out]``; the port stores
``weight [out, in]`` (``nn.Linear``). ``patch_embed.kernel`` is
``[P·P·3, C]`` in ``(ph, pw, c)`` order and becomes ``weight [C, P·P·3]``
in the same order. ``ls1``/``ls2`` are copied when present (absent means
ones, as in the kernels). The caller converts the JAX arrays with
``jax.tree.map(np.asarray, params)``; this module never sees JAX.

An int8 record of ``rajni_tpu.quant`` (``{"int8": [in, out], "scale": [1,
out]}`` as a kernel) becomes the port's ``{"int8": [out, in], "scale":
[out]}`` (:mod:`..quant`); ``tree_to`` keeps its int8 and fp32 dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.vit import Params, tree_to


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


def _dense(d: dict) -> dict:
    k = d["kernel"]
    if isinstance(k, dict):  # int8 record
        weight = {"int8": _t(k["int8"]),
                  "scale": torch.from_numpy(np.array(k["scale"], np.float32).reshape(-1))}
    else:
        weight = _t(k)
    return {"weight": weight, "bias": torch.from_numpy(np.array(d["bias"]))}


def _norm(d: dict) -> dict:
    return {"scale": torch.from_numpy(np.array(d["scale"])),
            "bias": torch.from_numpy(np.array(d["bias"]))}


def params_from_numpy(tree: dict, dtype=None, device="cpu") -> Params:
    """numpy ``rajni_tpu`` tree → the port's parameter dictionary."""
    for key in ("reg_token", "dist_token", "fc_norm"):
        if key in tree:
            raise NotImplementedError(f"extended variant parameter {key!r} is not ported yet")
    out: Params = {
        "patch_embed": _dense(tree["patch_embed"]),
        "cls_token": torch.from_numpy(np.array(tree["cls_token"])),
        "pos_embed": torch.from_numpy(np.array(tree["pos_embed"])),
        "norm": _norm(tree["norm"]),
        "head": _dense(tree["head"]),
        "blocks": [],
    }
    for blk in tree["blocks"]:
        if "q_norm" in blk["attn"]:
            raise NotImplementedError("qk-norm blocks are not ported yet")
        b = {
            "norm1": _norm(blk["norm1"]),
            "attn": {"qkv": _dense(blk["attn"]["qkv"]), "proj": _dense(blk["attn"]["proj"])},
            "norm2": _norm(blk["norm2"]),
            "mlp": {"fc1": _dense(blk["mlp"]["fc1"]), "fc2": _dense(blk["mlp"]["fc2"])},
        }
        for name in ("ls1", "ls2"):
            if blk.get(name) is not None:
                b[name] = torch.from_numpy(np.array(blk[name]))
        out["blocks"].append(b)
    kw = {"device": device} if dtype is None else {"device": device, "dtype": dtype}
    return tree_to(out, **kw)
