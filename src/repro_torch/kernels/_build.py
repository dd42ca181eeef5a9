"""Build and load the hand-written CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled on first use by ``nvcc`` into
its own shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds. Libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is rebuilt
and never loaded stale. :func:`build_all` starts one ``nvcc`` per source at
once and waits for all of them.

Every C entry point takes device pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises on a
non-zero code and counts the launch. Nothing is built or loaded at import
time: this module imports on machines with neither a GPU nor ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


class Kernel:
    """One kernel of a ``csrc/<source>.cu`` library: its C entry points, its
    build, and the count of launches made through :meth:`launch`. Several
    kernels may share one source (``source=``, default ``name``); they then
    share one library and keep their own counts."""

    def __init__(self, name: str, entry_points: Dict[str, Sequence], source: Optional[str] = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.entry_points = dict(entry_points)
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, object] = {}

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def _command(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(self.source)]

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` unless the library is already built; returns the
        running process (or None)."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            self._command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} (exit {proc.returncode}):\n{out}")
        os.replace(proc.tmp_path, self.library)  # type: ignore[attr-defined]

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            for fn, argtypes in self.entry_points.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = I
                self._fns[fn] = f
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call C entry point ``fn``; raise on a CUDA error; count the launch."""
        f = self._fns.get(fn) or getattr(self.lib(), fn)
        err = f(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}")
        self.launches += 1


def build_all(kernels: Sequence[Kernel]) -> None:
    """Compile every source in parallel (one ``nvcc`` each), then load."""
    by_source = {k.source: k for k in kernels}
    procs = [(k, k.start_build()) for k in by_source.values()]
    errors = []
    for k, p in procs:
        try:
            k.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()


def stream_ptr(device) -> int:
    """The raw handle of the current CUDA stream of ``device`` (a tensor's,
    so its index is set), read without building a ``torch.cuda.Stream``
    object, which costs microseconds a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The C side's element-type code: 0 = float32, 1 = bfloat16."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return _DTYPE_CODES[dtype]
