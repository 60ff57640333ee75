"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher.  On first use
it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``kernels/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``.  The library's file name carries a hash of the source, of the
``csrc/*.cuh`` headers it includes (directly or through another header) and
of the flags, so a changed source or header is rebuilt; the compiler's output
(with the ``ptxas`` register and spill report) is kept beside it as ``.log``.

Nothing is built unless a kernel is launched, and nothing is built from
outside the package's own sources.  A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# loaded libraries by kernel name; a CDLL cannot be unloaded, so this cache
# lives as long as the process
_LIBRARIES: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "cmacionize_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def local_includes(source: Path) -> list:
    """The ``csrc/`` headers that ``source`` includes with ``#include "..."``,
    directly or through another such header, in order of first inclusion."""
    found, pending = [], [source]
    while pending:
        for name in _INCLUDE.findall(pending.pop(0).read_text()):
            header = CSRC_DIR / name
            if header not in found:
                found.append(header)
                pending.append(header)
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed by the content
    of the source, of its headers and of the flags."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in local_includes(source):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def compile_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (always) into :func:`library_path`."""
    source = CSRC_DIR / f"{name}.cu"
    target = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, str(source)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"cmacionize_torch: nvcc failed on {source.name} "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            compile_library(name)
        lib = ctypes.CDLL(str(path))
        _LIBRARIES[name] = lib
    return lib
