"""Builds the port's CUDA kernels into one shared library, at first use.

Every ``csrc/*.cu`` exports a plain C entry point; ``nvcc`` compiles
the sources in parallel (one process each, all started together) for
``sm_90a`` and links them into ``build/kernels/<hash>/libreprokernels.so``
under the repository root, where ``<hash>`` covers the sources and the
flags, so an edited source builds anew and an unchanged one loads the
existing library.  The library is loaded with :mod:`ctypes`; nothing
here includes PyTorch's headers, which keeps a cold build to seconds.

``nvcc`` comes from ``$CUDA_HOME/bin``, else ``PATH``, else
``/usr/local/cuda`` (PyTorch's own lookup); without one the build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "library", "build_dir", "find_nvcc"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB = "libreprokernels.so"


def find_nvcc() -> str:
    # PyTorch's lookup: $CUDA_HOME (or $CUDA_PATH), else the nvcc on
    # PATH, else /usr/local/cuda.
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "/nonexistent") / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return str(nvcc)


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def build_dir() -> Path:
    """``build/kernels/<hash of the sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _ROOT / "build" / "kernels" / h.hexdigest()[:16]


def _compile(out: Path) -> None:
    """Compile every ``.cu`` in parallel, link, and move the library to
    ``out``.  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``out/build.log``."""
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        tmp = Path(tmp)
        cus = [s for s in _sources() if s.suffix == ".cu"]
        procs = []
        for src in cus:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{text}")
            if p.returncode:
                failed.append(src.name)
        (out / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = tmp / _LIB
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # Atomic within the directory: a concurrent build of the same
        # sources replaces the file with an identical one.
        os.replace(lib, out / _LIB)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    out = build_dir()
    if not (out / _LIB).is_file():
        _compile(out)
    lib = ctypes.CDLL(str(out / _LIB))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.repro_rmsnorm.argtypes = [p, p, p, i, i, f, i, p]
    lib.repro_rmsnorm.restype = i
    lib.repro_decode_attention.argtypes = [
        p, p, p, p, p,              # q, k, v, lengths, out
        i, i, i, i, i,              # B, H, Hkv, T, D
        ll, ll, ll, ll, ll, ll,     # k strides (b, t, h), v strides
        f, i, i, p]                 # scale, q dtype, kv dtype, stream
    lib.repro_decode_attention.restype = i
    return lib
