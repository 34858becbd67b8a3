"""Build, load and launch the hand-written CUDA kernels (``csrc/``).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface, on first use, into
``<repo>/build/repro_torch/`` (a directory git ignores).  The library
name carries a digest of the sources, so an edited kernel is rebuilt and
a stale one never loaded.  :func:`build` starts one ``nvcc`` per source,
all at once, and returns their ``-Xptxas -v`` reports (registers, shared
memory, spills).

:func:`load` loads a library with ``ctypes`` once per process, under a
lock, so two threads never build or load one source twice.
:class:`CudaKernel` is the handle a wrapper launches through: it passes
device pointers and PyTorch's current stream (the launching thread's),
raises on a non-zero ``cudaError_t`` from the launch, and counts its
launches (``launches`` — a plain integer that callers reset and read to
prove a path went through the kernel).  The count takes no lock and is
one per process: it is exact while one thread launches at a time, as in
the mapping service, whose worker thread does all of its Mapper's device
work.  (The sync counts of ``runtime.boundary`` are charged per thread;
this count is not.)

Nothing here runs at import: this module is imported on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CudaKernel", "build", "build_dir", "library_path", "load",
           "raise_on_error"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_ARCH = "arch=compute_90a,code=sm_90a"
_NVCC_FLAGS = ("-gencode", _ARCH, "-std=c++17", "-O3", "--fmad=false",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``<repo>/build/repro_torch`` — inside the checkout, git-ignored."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def library_path(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu``, keyed by a
    digest of that source and the shared headers."""
    h = hashlib.sha256()
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every missing library among ``names`` with one ``nvcc``
    process per source, all started together.  Returns ``{name: ptxas
    report}`` ("" for a library that was already built); raises with the
    compiler's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, lib)        # atomic: a reader never sees a partial
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


_LIBRARIES: dict = {}
_LOAD_LOCK = threading.Lock()


def load(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu``, built if missing and loaded
    once per process, with ``viem_error_string`` bound."""
    with _LOAD_LOCK:
        lib = _LIBRARIES.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            lib.viem_error_string.argtypes = [ctypes.c_int]
            lib.viem_error_string.restype = ctypes.c_char_p
            _LIBRARIES[source] = lib
    return lib


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = lib.viem_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")


class CudaKernel:
    """One C entry point of one ``csrc`` library, with a launch count.

    ``argtypes`` are the ctypes types of the entry's arguments (every
    pointer and the stream as ``c_void_p``); the entry returns a
    ``cudaError_t`` code as ``int``."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._lib

    def launch(self, *args) -> None:
        """Call the entry (arguments as ``argtypes`` says, the stream
        last) and raise if the launch was refused or failed."""
        lib = self.library()
        raise_on_error(lib, self._fn(*args), f"{self.name} kernel launch")
        self.launches += 1
