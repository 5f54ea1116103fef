"""
Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries are
named by a digest of their source and flags, so an edited source never
loads a stale build. They land in ``build/gordo_tpu_torch/`` beside the
package, which ``.gitignore`` covers. ``nvcc``'s output, including
``-Xptxas -v``'s register and shared-memory report, is kept in a
``.log`` beside each library. A source may also be built with extra
preprocessor defines (a variant kept for measurement); each set of
defines is a library of its own, keyed ``<stem>+<DEFINE>...``.

Nothing here runs at import, so every module imports on a machine
without ``nvcc`` or a card (the CPU tests rely on it).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from ..utils.postfork import register_postfork_reset

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gordo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _reset_after_fork() -> None:
    """A forked worker loads the libraries it launches itself, after its
    own CUDA context exists; the lock is rebound, never taken."""
    global _lock, _loaded
    _lock = threading.Lock()
    _loaded = {}


register_postfork_reset(_reset_after_fork, name="ops._build.loaded")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME")


def kernel_sources() -> List[Path]:
    """Every CUDA source of the package."""
    return sorted(CSRC.glob("*.cu"))


def _flags(defines: Sequence[str]) -> List[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_name(source: Path, defines: Sequence[str] = ()) -> str:
    """The key of a build: the source's stem, then ``+DEFINE`` for each define."""
    return "".join([source.stem, *(f"+{d}" for d in defines)])


def library_path(source: Path, defines: Sequence[str] = ()) -> Path:
    """Where ``source``'s shared library goes: named by a digest of the
    source text and the compiler flags."""
    digest = hashlib.sha1(source.read_bytes() + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:12]}.so"


def build(
    sources: Optional[Iterable[Path]] = None,
    variants: Iterable[Sequence[str]] = ((),),
) -> Dict[str, Path]:
    """Compile every source once for each set of preprocessor defines in
    ``variants`` whose library is missing, one ``nvcc`` for each, all
    started together; returns ``{library_name: library path}``. Raises
    :class:`KernelBuildError` with the compiler's output on a failure."""
    jobs = [
        (src, tuple(defines))
        for src in (kernel_sources() if sources is None else sources)
        for defines in variants
    ]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libraries = {library_name(src, d): library_path(src, d) for src, d in jobs}
    running = []
    try:
        for src, defines in jobs:
            lib = libraries[library_name(src, defines)]
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = lib.with_suffix(".log")
            with open(log, "wb") as log_file:
                proc = subprocess.Popen(
                    [nvcc_path(), *_flags(defines), "-o", str(tmp), str(src)],
                    stdout=log_file,
                    stderr=subprocess.STDOUT,
                )
            running.append((proc, library_name(src, defines), tmp, lib, log))
        failures = []
        for proc, name, tmp, lib, log in running:
            if proc.wait() == 0:
                os.replace(tmp, lib)
            else:
                failures.append(f"{name}:\n{log.read_text(errors='replace')[-4000:]}")
        if failures:
            raise KernelBuildError("nvcc failed for " + "\n".join(failures))
    finally:
        for proc, *_ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libraries


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built on first use."""
    source = CSRC / f"{name}.cu"
    key = library_name(source, defines)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path = build([source], [defines])[key]
            lib = ctypes.CDLL(str(path))
            _loaded[key] = lib
        return lib
