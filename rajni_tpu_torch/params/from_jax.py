"""Carry a ``rajni_tpu`` parameter tree, given as numpy arrays, into the
port's layout.

The JAX tree stores linear kernels ``[in, out]``; the port stores
``weight [out, in]`` (``nn.Linear``). ``patch_embed.kernel`` is
``[P·P·3, C]`` in ``(ph, pw, c)`` order and becomes ``weight [C, P·P·3]``
in the same order. ``ls1``/``ls2`` are copied when present (absent means
ones, as in the kernels). The caller converts the JAX arrays with
``jax.tree.map(np.asarray, params)``; this module never sees JAX. A leaf
may also be a CPU torch tensor (the bfloat16 arrays of a msgpack checkpoint,
:mod:`.io`, which plain numpy cannot hold).

:func:`params_to_numpy` is the inverse: the port's dictionary back into the
JAX tree's layout, for :func:`.io.save_params`.

An int8 record of ``rajni_tpu.quant`` (``{"int8": [in, out], "scale": [1,
out]}`` as a kernel) becomes the port's ``{"int8": [out, in], "scale":
[out]}`` (:mod:`..quant`); ``tree_to`` keeps its int8 and fp32 dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.vit import Params, tree_to


# the optional top-level and attention leaves (the extended timm variants)
_NORMS = ("norm", "fc_norm")
_TOKENS = ("dist_token", "reg_token")
_QK_NORMS = ("q_norm", "k_norm")


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # JAX's numpy bfloat16, which torch cannot read
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _t(a) -> torch.Tensor:
    return _tensor(a).t().contiguous()


def _dense(d: dict) -> dict:
    k = d["kernel"]
    if isinstance(k, dict):  # int8 record
        weight = {"int8": _t(k["int8"]), "scale": _tensor(k["scale"]).float().reshape(-1)}
    else:
        weight = _t(k)
    return {"weight": weight, "bias": _tensor(d["bias"])}


def _norm(d: dict) -> dict:
    return {"scale": _tensor(d["scale"]), "bias": _tensor(d["bias"])}


def params_from_numpy(tree: dict, dtype=None, device="cpu") -> Params:
    """numpy ``rajni_tpu`` tree → the port's parameter dictionary. The
    extended variants' leaves come along: ``fc_norm`` (in place of
    ``norm``), ``dist_token``, ``head_dist``, ``reg_token`` and each block's
    ``q_norm``/``k_norm``."""
    out: Params = {
        "patch_embed": _dense(tree["patch_embed"]),
        "cls_token": _tensor(tree["cls_token"]),
        "pos_embed": _tensor(tree["pos_embed"]),
        "head": _dense(tree["head"]),
        "blocks": [],
    }
    for key in _NORMS:
        if key in tree:
            out[key] = _norm(tree[key])
    for key in _TOKENS:
        if key in tree:
            out[key] = _tensor(tree[key])
    if "head_dist" in tree:
        out["head_dist"] = _dense(tree["head_dist"])
    for blk in tree["blocks"]:
        attn = {"qkv": _dense(blk["attn"]["qkv"]), "proj": _dense(blk["attn"]["proj"])}
        for key in _QK_NORMS:
            if key in blk["attn"]:
                attn[key] = _norm(blk["attn"][key])
        b = {
            "norm1": _norm(blk["norm1"]),
            "attn": attn,
            "norm2": _norm(blk["norm2"]),
            "mlp": {"fc1": _dense(blk["mlp"]["fc1"]), "fc2": _dense(blk["mlp"]["fc2"])},
        }
        for name in ("ls1", "ls2"):
            if blk.get(name) is not None:
                b[name] = _tensor(blk[name])
        out["blocks"].append(b)
    kw = {"device": device} if dtype is None else {"device": device, "dtype": dtype}
    return tree_to(out, **kw)


def _leaf(t: torch.Tensor, transpose: bool = False):
    """A CPU copy in numpy, or a torch tensor where numpy has no dtype for
    it (bfloat16)."""
    t = t.detach().cpu()
    if transpose:
        t = t.t()
    t = t.contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _to_dense(d: dict) -> dict:
    w = d["weight"]
    if isinstance(w, dict):  # int8 record: [out, in] -> [in, out], scale [1, out]
        kernel = {"int8": _leaf(w["int8"], True), "scale": _leaf(w["scale"].reshape(1, -1))}
    else:
        kernel = _leaf(w, True)
    return {"kernel": kernel, "bias": _leaf(d["bias"])}


def _to_norm(d: dict) -> dict:
    return {"scale": _leaf(d["scale"]), "bias": _leaf(d["bias"])}


def params_to_numpy(params: Params) -> dict:
    """The port's parameter dictionary → the ``rajni_tpu`` tree layout
    (``kernel [in, out]``), as numpy arrays; bfloat16 leaves stay CPU torch
    tensors, since numpy has no bfloat16."""
    out = {
        "patch_embed": _to_dense(params["patch_embed"]),
        "cls_token": _leaf(params["cls_token"]),
        "pos_embed": _leaf(params["pos_embed"]),
        "head": _to_dense(params["head"]),
        "blocks": [],
    }
    for key in _NORMS:
        if key in params:
            out[key] = _to_norm(params[key])
    for key in _TOKENS:
        if key in params:
            out[key] = _leaf(params[key])
    if "head_dist" in params:
        out["head_dist"] = _to_dense(params["head_dist"])
    for blk in params["blocks"]:
        attn = {k: _to_dense(blk["attn"][k]) for k in ("qkv", "proj")}
        for key in _QK_NORMS:
            if key in blk["attn"]:
                attn[key] = _to_norm(blk["attn"][key])
        b = {
            "norm1": _to_norm(blk["norm1"]),
            "attn": attn,
            "norm2": _to_norm(blk["norm2"]),
            "mlp": {k: _to_dense(blk["mlp"][k]) for k in ("fc1", "fc2")},
        }
        for name in ("ls1", "ls2"):
            if name in blk:
                b[name] = _leaf(blk[name])
        out["blocks"].append(b)
    return out
