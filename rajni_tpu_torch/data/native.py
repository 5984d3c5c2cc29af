"""ctypes loader for the C++ preprocessing library (port of
``rajni_tpu/data/native.py``).

``_native/preprocess.cpp`` is built with ``g++`` into
``rajni_tpu_torch/_build/native-<digest>/libpreprocess.so``, the digest
covering the source and the flags, so an edited source builds anew and an
unchanged one is reused. The build holds an ``fcntl`` lock on a file beside
the library, compiles to a name of its own and moves the result into place
with ``os.replace``: processes that build at once all load a whole library.

:func:`preprocess_native` has :func:`.pipeline.preprocess`'s geometry
(:func:`.pipeline.resize_crop_geometry`) and resamples in double precision
where PIL uses fixed-point coefficients: values agree within ±1/255 a
channel, not bit for bit. The ctypes call releases the GIL, so the
DataLoader's thread pool scales across cores.

``RAJNI_NATIVE=0`` makes :func:`load` return None (the PIL path), checked on
every call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .pipeline import resize_crop_geometry

_SRC = Path(__file__).resolve().parent / "_native" / "preprocess.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIBRARY = "libpreprocess.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # why the library did not build or load


def library_path(root: str | os.PathLike | None = None) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return Path(root or BUILD_ROOT) / f"native-{h.hexdigest()[:16]}" / LIBRARY


def build(root: str | os.PathLike | None = None) -> Path:
    """Build the library under ``root`` (default ``rajni_tpu_torch/_build``)
    unless it is there; return its path. Raises ``RuntimeError`` with
    ``g++``'s output when the compile fails."""
    lib = library_path(root)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.is_file():
            tmp = lib.parent / f".{LIBRARY}.{os.getpid()}.{threading.get_ident()}"
            p = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed ({p.returncode}):\n{p.stderr}")
            os.replace(tmp, lib)
    return lib


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.rajni_preprocess.restype = ctypes.c_int
    lib.rajni_preprocess.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),    # src
        ctypes.c_int, ctypes.c_int,        # h, w
        ctypes.c_int, ctypes.c_int,        # nh, nw
        ctypes.c_int,                      # crop
        ctypes.c_int, ctypes.c_int,        # left, top
        ctypes.POINTER(ctypes.c_float),    # mean
        ctypes.POINTER(ctypes.c_float),    # std
        ctypes.POINTER(ctypes.c_float),    # out
    ]
    return lib


def load() -> ctypes.CDLL | None:
    """The library, built on first use; None where ``RAJNI_NATIVE=0`` or it
    did not build or load (:func:`error` says why)."""
    global _lib, _error
    if os.environ.get("RAJNI_NATIVE", "1") == "0":
        return None
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(build())
            except (OSError, RuntimeError) as e:
                _error = str(e)
    return _lib


def available() -> bool:
    return load() is not None


def error() -> str | None:
    """Why the library did not build or load (None if it did, or was not tried)."""
    return _error


def preprocess_native(
    rgb: np.ndarray,
    img_size: int,
    resize: int,
    mean: np.ndarray,
    std: np.ndarray,
) -> np.ndarray:
    """Resize the shorter side (bicubic), center crop, normalize:
    ``[H, W, 3] uint8`` → ``[img_size, img_size, 3] float32`` NHWC."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native preprocessing unavailable: {_error or 'RAJNI_NATIVE=0'}")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    nw, nh, left, top = resize_crop_geometry(w, h, img_size, resize)
    out = np.empty((img_size, img_size, 3), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    rc = lib.rajni_preprocess(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, nh, nw, img_size, left, top,
        mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"rajni_preprocess failed with code {rc}")
    return out
