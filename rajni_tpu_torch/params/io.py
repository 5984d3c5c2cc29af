"""Parameter checkpoints in the JAX package's msgpack format.

Port of ``rajni_tpu/params/io.py``: one file drives both packages. A file is
flax's msgpack of the JAX parameter tree (``kernel [in, out]`` linears,
``blocks`` a list), the format ``flax.serialization.msgpack_serialize``
writes; :func:`load_params` reads it through
:func:`.from_jax.params_from_numpy` and :func:`save_params` writes it
through its inverse :func:`.from_jax.params_to_numpy`.

The port carries its own small msgpack codec (maps, arrays, str, bin, int,
float, bool, nil, and ext type 1), since no msgpack package is assumed.
Flax's ndarray ext (type 1) holds the msgpack triple ``(shape, dtype name,
C-order bytes)``; numpy has no bfloat16, so a ``bfloat16`` array goes through
an int16 view and is returned as a CPU torch tensor. Flax splits arrays over
2**30 bytes into chunks, which no ViT up to ViT-H needs: such a file raises.
Orbax checkpoint directories are not read. :func:`load_checkpoint_auto` also
takes a timm ``.pth`` (:mod:`.convert`).
"""

from __future__ import annotations

import io
import struct
from typing import Any

import numpy as np
import torch

from .from_jax import params_from_numpy, params_to_numpy

_NDARRAY_EXT = 1
_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# msgpack encoding
# ---------------------------------------------------------------------------


def _array_bytes(a) -> bytes:
    """Flax's ndarray ext payload: msgpack ``(shape, dtype name, bytes)``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _packb([list(t.shape), _BF16, t.view(torch.int16).numpy().tobytes()])
        a = t.numpy()
    a = np.ascontiguousarray(a)
    if a.dtype.hasobject or a.dtype.names:
        raise ValueError(f"cannot serialize an array of dtype {a.dtype}")
    return _packb([list(a.shape), a.dtype.name, a.tobytes()])


def _pack(obj, out: io.BytesIO) -> None:
    w = out.write
    if obj is None:
        w(b"\xc0")
    elif obj is True or obj is False:
        w(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            w(struct.pack(">B", obj))
        elif -32 <= obj < 0:
            w(struct.pack(">b", obj))
        elif 0 <= obj < 2**64:
            w(b"\xcf" + struct.pack(">Q", obj))
        elif -(2**63) <= obj < 0:
            w(b"\xd3" + struct.pack(">q", obj))
        else:
            raise ValueError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        w(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        n = len(b)
        if n < 32:
            w(struct.pack(">B", 0xA0 | n))
        elif n < 2**8:
            w(b"\xd9" + struct.pack(">B", n))
        elif n < 2**16:
            w(b"\xda" + struct.pack(">H", n))
        else:
            w(b"\xdb" + struct.pack(">I", n))
        w(b)
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 2**8:
            w(b"\xc4" + struct.pack(">B", n))
        elif n < 2**16:
            w(b"\xc5" + struct.pack(">H", n))
        else:
            w(b"\xc6" + struct.pack(">I", n))
        w(obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            w(struct.pack(">B", 0x90 | n))
        elif n < 2**16:
            w(b"\xdc" + struct.pack(">H", n))
        else:
            w(b"\xdd" + struct.pack(">I", n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            w(struct.pack(">B", 0x80 | n))
        elif n < 2**16:
            w(b"\xde" + struct.pack(">H", n))
        else:
            w(b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        data = _array_bytes(obj)
        n = len(data)
        if n < 2**8:
            w(b"\xc7" + struct.pack(">Bb", n, _NDARRAY_EXT))
        elif n < 2**16:
            w(b"\xc8" + struct.pack(">Hb", n, _NDARRAY_EXT))
        else:
            w(b"\xc9" + struct.pack(">Ib", n, _NDARRAY_EXT))
        w(data)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _packb(obj) -> bytes:
    out = io.BytesIO()
    _pack(obj, out)
    return out.getvalue()


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------

_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, nbytes: int) -> int:
        return self.unpack(_LEN[nbytes])

    def read(self) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(self.take(self.length(1 << (b - 0xD9)))).decode()
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.length(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 if b == 0xDE else 4))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.length(1 << (b - 0xC7))
            return self.ext(self.unpack(">b"), bytes(self.take(n)))
        if b in _FIXEXT:
            code = self.unpack(">b")
            return self.ext(code, bytes(self.take(_FIXEXT[b])))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    @staticmethod
    def ext(code: int, data: bytes):
        if code != _NDARRAY_EXT:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, buf = _unpackb(data)
        name = name.decode() if isinstance(name, bytes) else name
        if name == _BF16:
            a = np.frombuffer(buf, dtype=np.int16).reshape(shape)
            return torch.from_numpy(a.copy()).view(torch.bfloat16)
        return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _restore_blocks(obj: Any) -> Any:
    """msgpack's ``{"0": v0, "1": v1, ...}`` encoding of a list back into a
    list (only where every key is a decimal string), recursively; flax
    chunked arrays raise."""
    if isinstance(obj, dict):
        if "__msgpack_chunked_array__" in obj:
            raise ValueError("chunked msgpack arrays (over 2**30 bytes) are not supported")
        restored = {k: _restore_blocks(v) for k, v in obj.items()}
        if restored and all(isinstance(k, str) and k.isdigit() for k in restored):
            return [restored[str(i)] for i in range(len(restored))]
        return restored
    if isinstance(obj, list):
        return [_restore_blocks(v) for v in obj]
    return obj


def save_params(path: str, params) -> None:
    """Write the port's parameter dictionary as the JAX package's msgpack
    checkpoint (loadable by ``rajni_tpu.params.io.load_params``)."""
    with open(path, "wb") as f:
        f.write(_packb(params_to_numpy(params)))


def load_params(path: str, dtype: torch.dtype | None = None, device="cpu"):
    """Read a msgpack checkpoint written by either package into the port's
    layout. ``dtype`` casts every leaf but the int8 records (whose int8 and
    fp32 dtypes are part of the format, as JAX's ``_cast_tree`` keeps
    them)."""
    with open(path, "rb") as f:
        tree = _restore_blocks(_unpackb(f.read()))
    return params_from_numpy(tree, dtype=dtype, device=device)


def load_checkpoint_auto(path: str, model: str, dtype: torch.dtype | None = None,
                         device="cpu"):
    """A checkpoint of either kind: a torch ``.pth``, ``.pt`` or ``.bin``
    (a timm state_dict) is converted for ``model`` with the extended-variant
    flags its keys carry (:func:`.convert.adapt_config`, then
    :func:`.convert.convert_timm_state_dict`, the pos-embed resampled to its
    grid), anything else is read as msgpack (:func:`load_params`). The
    caller reads the variant back from the tree
    (:func:`..models.vit.adapt_config_to_params`)."""
    if path.endswith((".pth", ".pt", ".bin")):
        from ..models.vit import get_config
        from .convert import adapt_config, convert_timm_state_dict, load_torch_checkpoint

        sd = load_torch_checkpoint(path)
        tree = convert_timm_state_dict(sd, adapt_config(get_config(model), sd))
        return params_from_numpy(tree, dtype=dtype, device=device)
    return load_params(path, dtype=dtype, device=device)
