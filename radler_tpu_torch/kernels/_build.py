"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface.  The library lands in
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
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


class BuildInfo:
    """What the last build in this process did: the library's path, the
    wall seconds of the compiles and the link (0.0 when a cached library was
    reused) and the compilers' output, which holds the ``-Xptxas -v``
    register lines."""

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
        start = time.perf_counter()
        # Build to private names and rename, so concurrent processes never
        # load a half-written library.
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objects = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
            steps = [
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objects)
            ]
            procs = [
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for cmd in steps
            ]
            results = [(cmd, proc.communicate()[0], proc.returncode)
                       for cmd, proc in zip(steps, procs)]
            lib = str(Path(tmp) / target.name)
            if all(rc == 0 for _, _, rc in results):
                link = [_nvcc(), "-shared", "-o", lib, *objects]
                proc = subprocess.run(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                results.append((link, proc.stdout, proc.returncode))
            BuildInfo.seconds = time.perf_counter() - start
            BuildInfo.log = "".join(log for _, log, _ in results)
            for cmd, log, rc in results:
                if rc != 0:
                    raise RuntimeError(
                        f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}"
                    )
            os.replace(lib, target)
    BuildInfo.path = target
    _lib = ctypes.CDLL(str(target))
    return _lib
