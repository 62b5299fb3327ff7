"""Build the package's native code at first use and load it with ctypes.

Two libraries, each with a plain C interface:

* the CUDA kernels: every ``csrc/*.cu`` source is compiled by its own
  ``nvcc`` for Hopper (``sm_90a``), all at once, and the objects are linked
  into one shared library (:func:`library`).  Nothing here runs for CPU
  tensors: the wrappers call :func:`library` only on their CUDA path.
* the host helpers: every ``csrc/*.cc`` source (the facet splitter's
  Dijkstra search), built by the host's C++ compiler for CPU and CUDA runs
  alike (:func:`host_library`).

Each library lands in ``build/radler_tpu_torch/<hash>/`` at the root of the
checkout, keyed by a hash of its sources and flags, so an edited source
builds anew and an unchanged one is reused.
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
HOST_SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cc")))
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
HOST_FLAGS = ("-std=c++17", "-O3", "-fPIC")


class BuildInfo:
    """What the last build of the CUDA kernels in this process did: the
    library's path, the wall seconds of the compiles and the link (0.0 when
    a cached library was reused) and the compilers' output, which holds the
    ``-Xptxas -v`` register lines."""

    path: Path = None
    seconds: float = 0.0
    log: str = ""


_lib = None
_host_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler (c++, g++ or $CXX) to build "
                           f"{[s.name for s in HOST_SOURCES]}")
    return found


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(compiler: str, flags, sources, name: str):
    """Compile ``sources`` (one process each, all at once) and link them
    into ``name`` under the build root, unless that build exists; returns
    (path, seconds, compiler output).  Raises with the output when a step
    fails."""
    out_dir = BUILD_ROOT / _digest(sources, flags)
    target = out_dir / name
    if target.exists():
        return target, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    # Build to private names and rename, so concurrent processes never load
    # a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objects = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        steps = [
            [compiler, *flags, "-c", "-o", obj, str(src)]
            for src, obj in zip(sources, objects)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in steps
        ]
        results = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in zip(steps, procs)]
        lib = str(Path(tmp) / name)
        if all(rc == 0 for _, _, rc in results):
            link = [compiler, "-shared", "-o", lib, *objects]
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            results.append((link, proc.stdout, proc.returncode))
        seconds = time.perf_counter() - start
        log = "".join(out for _, out, _ in results)
        for cmd, out, rc in results:
            if rc != 0:
                raise RuntimeError(
                    f"{Path(compiler).name} failed ({rc}): {' '.join(cmd)}\n"
                    f"{out}"
                )
        os.replace(lib, target)
    return target, seconds, log


def library() -> ctypes.CDLL:
    """The loaded CUDA kernel library, built first if no build of these
    sources exists.  Raises with the compiler's output when ``nvcc``
    fails."""
    global _lib
    if _lib is None:
        path, BuildInfo.seconds, BuildInfo.log = _build(
            _nvcc(), NVCC_FLAGS, SOURCES, "libradler_tpu_torch.so")
        BuildInfo.path = path
        _lib = ctypes.CDLL(str(path))
    return _lib


def host_library() -> ctypes.CDLL:
    """The loaded host-helper library, built first with the C++ compiler if
    no build of these sources exists."""
    global _host_lib
    if _host_lib is None:
        path, _, _ = _build(_cxx(), HOST_FLAGS, HOST_SOURCES,
                            "libradler_tpu_torch_host.so")
        _host_lib = ctypes.CDLL(str(path))
    return _host_lib
