"""One build path for the port's CUDA kernels.

Each kernel module registers its sources with :func:`register`: one
:class:`CudaLibrary` per ``.cu`` file, with the C entry point it exports and
that entry's ``ctypes`` argument types.  At first use the source is compiled
by ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
under ``build/repro_torch/`` at the root of the checkout, named by a hash of
the sources and flags (so a stale build is never loaded), then loaded with
``ctypes``.  :func:`build` compiles several at once, one ``nvcc`` process
per source, all started together; with no names it builds every registered
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclass(frozen=True)
class CudaLibrary:
    """One ``.cu`` source under ``csrc``, its headers, and its C entry."""
    name: str
    csrc: Path
    source: str
    headers: tuple[str, ...]
    entry: str
    argtypes: tuple

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for fname in (self.source,) + self.headers:
            h.update((self.csrc / fname).read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"


LIBRARIES: dict[str, CudaLibrary] = {}
build_logs: dict[str, str] = {}   # nvcc's output (ptxas -v) per library
_entries: dict = {}            # name -> loaded C entry point


def register(lib: CudaLibrary) -> CudaLibrary:
    LIBRARIES[lib.name] = lib
    return lib


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names=None) -> dict[str, Path]:
    """Compile every named library (default: all registered) that is not
    built yet, one ``nvcc`` per source, all started together.  Returns the
    library paths; raises with nvcc's output if any build fails."""
    libs = [LIBRARIES[n] for n in (LIBRARIES if names is None else names)]
    paths = {lib.name: lib.path() for lib in libs}
    todo = [lib for lib in libs if not paths[lib.name].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for lib in todo:
            tmp = paths[lib.name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(lib.csrc / lib.source)]
            procs.append((lib.name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp))
        failed = []
        for name, proc, tmp in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" +
                               "\n".join(failed))
    return paths


def entry(name: str):
    """The loaded C entry point of library ``name`` (built at first use)."""
    fn = _entries.get(name)
    if fn is None:
        lib = LIBRARIES[name]
        fn = getattr(ctypes.CDLL(str(build((name,))[name])), lib.entry)
        fn.argtypes = list(lib.argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def check_status(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError``)."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
