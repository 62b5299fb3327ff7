"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface.  The library lands in
``build/radler_tpu_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused.  Nothing here runs for CPU tensors: the wrappers
call :func:`library` only on their CUDA path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
BUILD_ROOT = _PACKAGE.parent / "build" / "radler_tpu_torch"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


class BuildInfo:
    """What the last build in this process did: the library's path, the
    seconds ``nvcc`` took (0.0 when a cached library was reused) and the
    compiler's output, which holds the ``-Xptxas -v`` register lines."""

    path: Path = None
    seconds: float = 0.0
    log: str = ""


_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if no build of these sources
    exists.  Raises with the compiler's output when ``nvcc`` fails."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _digest()
    target = out_dir / "libradler_tpu_torch.so"
    if not target.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # Build to a private name and rename, so concurrent processes never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BuildInfo.seconds = time.perf_counter() - start
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{BuildInfo.log}"
            )
        os.replace(tmp, target)
    BuildInfo.path = target
    _lib = ctypes.CDLL(str(target))
    return _lib
