"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`. The build
happens at first use, into ``_build/`` beside this file (listed in
``.gitignore``) or, once ``runtime.compile_cache.enable`` has been called,
into its framework-keyed directory, under a name keyed by the source's
content and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is; the cache counts loads, builds and unloadable files.
Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_COUNTERS: List["LaunchCounter"] = []


class LaunchCounter:
    """Count of kernel launches made by one wrapper. The wrapper adds one
    where it launches its kernel and nowhere else, so a run can show that
    its main path went through the kernel. Every counter is registered
    (:func:`counter_values`): a captured CUDA graph takes back the counts
    its capture made and adds them at each replay."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()
        _COUNTERS.append(self)

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def counter_values() -> Dict["LaunchCounter", int]:
    return {c: c.value for c in _COUNTERS}


def build_dir() -> Path:
    """Where the libraries are built: the compile cache's directory when it
    is enabled, else ``BUILD_DIR``."""
    from deeplearning4j_tpu_torch.runtime import compile_cache
    d = compile_cache.cache_dir()
    return Path(d) if d else BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


class NativeLibrary:
    """One ``csrc/<name>.cu`` source and the library built from it.
    ``declare`` sets ``argtypes``/``restype`` of the exported functions
    once the library is loaded."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def _target(self) -> Path:
        h = hashlib.sha256()
        for p in sorted(CSRC.glob("*.cu*")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return build_dir() / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start nvcc for this source unless the library is already built;
        returns ``(process, tmp_path, target, t0)`` or ``None``."""
        target = self._target()
        if target.exists():
            return None
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, target, time.perf_counter()

    def _finish_build(self, started) -> None:
        if started is None:  # already built, by this process or an earlier one
            if self.build_seconds is None:
                self.build_seconds = 0.0
            return
        from deeplearning4j_tpu_torch.runtime import compile_cache
        proc, tmp, target, t0 = started
        out, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        compile_cache.STATS.record("compiles", self.build_seconds)
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, target)  # atomic: a concurrent builder loads either

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                from deeplearning4j_tpu_torch.runtime import compile_cache
                lib = compile_cache.load_library(
                    self._target(), lambda: self._finish_build(self._start_build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


_LIBRARIES: Dict[str, NativeLibrary] = {}


def register_library(lib: NativeLibrary) -> NativeLibrary:
    _LIBRARIES[lib.source.name] = lib
    return lib


def build_all() -> Dict[str, float]:
    """Build every registered kernel source at once, one ``nvcc`` process
    for each, all started together; then load them. Returns the seconds
    each build took (0.0 when the library was already built)."""
    libs: List[NativeLibrary] = list(_LIBRARIES.values())
    with_locks = [lib._lock for lib in libs]
    for lk in with_locks:
        lk.acquire()
    try:
        started = [(lib, lib._start_build()) for lib in libs if lib._lib is None]
        errors = []
        for lib, st in started:  # wait for every nvcc, even after a failure
            try:
                lib._finish_build(st)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]
    finally:
        for lk in with_locks:
            lk.release()
    for lib in libs:
        lib.load()
    return {name: lib.build_seconds or 0.0 for name, lib in _LIBRARIES.items()}
