"""Build and bind the hand-written CUDA kernels under ``rajni_tpu_torch/csrc``.

The ``csrc/*.cu`` files are compiled by ``nvcc`` (one process per source, all
started together) and linked into one shared library with a plain C
interface, ``librajni.so``, loaded with ``ctypes``. It goes to
``rajni_tpu_torch/_build/<digest>/``, where the digest covers every source
and the compiler flags, so an edited source is rebuilt and an unchanged tree
is reused. Nothing is built when a module is imported: the first launch, or
:func:`build`, does it. One process-wide lock covers the build and the load:
threads whose first launches meet (a serving registry runs one engine
thread a model) build and load the library once. The launch counters are
exact for one launching thread only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = (
    "mlp.cu", "attn_block.cu", "pruned_attn_block.cu", "ln_qkv.cu", "gather_attn.cu",
    "sdpa.cu", "pruned_block_full.cu", "attn_mlp_block.cu", "pruned_block_full_int8.cu",
    "block_full_int8.cu", "ln_mlp_int8.cu", "attn_block_int8.cu", "ln_qkv_int8.cu",
    "gather_attn_int8.cu", "pruned_attn_block_int8.cu", "ln_qkv_select.cu", "train_mlp.cu",
    "sdpa_bwd.cu", "gemm.cu", "short_attn.cu", "select.cu",
)
LIBRARY = "librajni.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / LIBRARY


# Held while the library is built or loaded: the objects and the temporary
# library are named by pid, so two threads of one process building at once
# would write the same files.
_LOCK = threading.RLock()


def build() -> dict[str, str]:
    """Build the library unless it exists; return each compiled source's
    ``ptxas -v`` report. Raises ``RuntimeError`` with nvcc's stderr when a
    compile or the link fails."""
    with _LOCK:
        return _build()


def _build() -> dict[str, str]:
    lib = library_path()
    if lib.is_file():
        return {}
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    procs = {}
    for s in SOURCES:
        obj = out_dir / f"{Path(s).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / s)]
        procs[s] = (obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    reports, failures = {}, []
    for s, (obj, p) in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            failures.append(f"nvcc {s} failed ({p.returncode}):\n{stderr}")
        reports[s] = stdout + stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    tmp = out_dir / f".{LIBRARY}.{tag}"
    objs = [str(obj) for obj, _ in procs.values()]
    p = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({p.returncode}):\n{p.stderr}")
    os.replace(tmp, lib)  # atomic: readers never see a partial .so
    for o in objs:
        os.remove(o)
    return reports


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            lib.rajni_error_string.argtypes = [ctypes.c_int]
            lib.rajni_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class CudaKernel:
    """One C entry point of the kernel library, with a launch counter.

    ``launches`` counts successful launches; it is a plain integer that a
    caller may reset to 0 to count the launches of one run. With
    ``counter``, the name of a C function that returns the library's own
    count of the kernel's launches (a kernel that other entry points launch
    inside their calls: B6's body), ``launches`` reads that count, so every
    launch is counted where it happens, and a call adds nothing itself.
    """

    def __init__(self, symbol: str, argtypes: list, counter: str | None = None):
        self.symbol = symbol
        self.argtypes = argtypes
        self.counter = counter
        self._count = 0  # the launches counted (or set) here
        self._base = 0  # the library's count when ``launches`` was last set
        self._fn = None

    def _library_count(self) -> int:
        """The library's count (0 before the library is loaded: it starts there)."""
        if _LIB is None:
            return 0
        fn = getattr(_LIB, self.counter)
        fn.restype = ctypes.c_longlong
        return fn()

    @property
    def launches(self) -> int:
        if self.counter is None:
            return self._count
        return self._count + self._library_count() - self._base

    @launches.setter
    def launches(self, value: int) -> None:
        self._count = value
        self._base = 0 if self.counter is None else self._library_count()

    def _load(self):
        fn = getattr(_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, *args) -> None:
        fn = self._fn or self._load()
        rc = fn(*args)
        if rc != 0:  # 1000 * launch step + cudaError_t
            step, code = divmod(rc, 1000)
            msg = _library().rajni_error_string(code).decode()
            raise RuntimeError(
                f"{self.symbol}: launch {step} failed with CUDA error {code} ({msg})"
            )
        if self.counter is None:
            self._count += 1


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_cuda(dtype: torch.dtype, **tensors: torch.Tensor | None) -> None:
    """Raise unless every given tensor is a contiguous, 16-byte aligned
    CUDA tensor of ``dtype`` (``None`` entries are skipped)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
