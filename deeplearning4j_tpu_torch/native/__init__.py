"""Native host components (C++, bound with ctypes).

Counterpart of ``deeplearning4j_tpu/native/__init__.py`` for the threshold
codec of the distributed trainer: :class:`ThresholdCodec` (sparse
sign-indexed and 2-bit bitmap encodings with a residual) and
:class:`TreeCodec` (the codec over a flattened parameter tree, with the
sparse-or-bitmap choice by predicted wire size). ``threshold_codec.cpp`` is
a copy of the JAX package's source; it is built with ``g++`` at first use
into ``_build/`` beside this file (listed in ``.gitignore``), under a name
keyed by the source's content, and nothing is built at import.

Unlike the JAX package, a codec does not fall back to numpy when no
compiler is present: the library builds or the call raises
:class:`NativeBuildError`. The numpy versions stay beside it as the plain
versions the tests hold the library against, bit for bit
(``ThresholdCodec(..., plain=True)``). The image pipeline of the JAX
package's ``native/`` is not ported here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "threshold_codec.cpp"
BUILD_DIR = _DIR / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()  # guards: _lib
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The codec library could not be built or loaded."""


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdl4j_threshold_codec-{key}.so"


def _build(out: Path) -> None:
    """Compile ``SOURCE`` into ``out`` (to a temporary name, then renamed, so
    a concurrent builder never loads half a file)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++"] + CXX_FLAGS + ["-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"could not run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded codec library, built at first use; raises
    :class:`NativeBuildError` when it cannot be built. The compile runs
    outside the lock (no subprocess wait under a lock); the build is atomic,
    so two racing builders at worst both compile."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(path))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.threshold_encode.restype = ctypes.c_int64
        lib.threshold_encode.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float, i32p,
                                         ctypes.c_int64]
        lib.threshold_decode.restype = None
        lib.threshold_decode.argtypes = [i32p, ctypes.c_int64, ctypes.c_float, f32p,
                                         ctypes.c_int64]
        lib.threshold_count.restype = ctypes.c_int64
        lib.threshold_count.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float]
        lib.bitmap_encode.restype = ctypes.c_int64
        lib.bitmap_encode.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float, u8p]
        lib.bitmap_decode.restype = None
        lib.bitmap_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_float, f32p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


# ------------------------------------------------------------ plain versions
def encode_plain(grad: np.ndarray, residual: np.ndarray, threshold: float):
    """numpy version of ``threshold_encode``: ``(encoded int32, new
    residual)``, bit for bit the C function's."""
    acc = grad + residual
    idx = np.nonzero((acc >= threshold) | (acc <= -threshold))[0]
    # the C sign convention: ``acc >= threshold`` emits a positive index
    # (at threshold 0 a tie encodes as +0)
    encoded = np.where(acc[idx] >= threshold, idx + 1, -(idx + 1)).astype(np.int32)
    acc[idx] -= np.where(encoded > 0, threshold, -threshold).astype(np.float32)
    return encoded, acc


def decode_plain(encoded: np.ndarray, threshold: float, target: np.ndarray) -> np.ndarray:
    """numpy version of ``threshold_decode``: invalid indices (0, |i| > n)
    are ignored, as in C."""
    valid = encoded[(np.abs(encoded) >= 1) & (np.abs(encoded) <= target.size)]
    np.add.at(target, np.abs(valid) - 1,
              np.where(valid > 0, threshold, -threshold).astype(np.float32))
    return target


def count_plain(grad: np.ndarray, residual: np.ndarray, threshold: float) -> int:
    acc = grad + residual
    return int(np.count_nonzero((acc >= threshold) | (acc <= -threshold)))


def bitmap_encode_plain(grad: np.ndarray, residual: np.ndarray, threshold: float):
    """numpy version of ``bitmap_encode``: ``(bytes, new residual)``, the
    same 2-bit little-endian packing."""
    acc = grad + residual
    code = np.zeros(acc.size, np.uint8)
    code[acc >= threshold] = 1
    code[(acc <= -threshold) & (code == 0)] = 2
    new_res = acc - np.where(code == 1, threshold,
                             np.where(code == 2, -threshold, 0.0)).astype(np.float32)
    nbytes = (acc.size + 3) // 4
    padded = np.zeros(nbytes * 4, np.uint8)
    padded[:acc.size] = code
    q = padded.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(np.uint8), new_res


def bitmap_decode_plain(encoded: np.ndarray, threshold: float, target: np.ndarray) -> np.ndarray:
    nbytes = (target.size + 3) // 4
    q = encoded[:nbytes]
    code = np.empty(nbytes * 4, np.uint8)
    for j in range(4):
        code[j::4] = (q >> (2 * j)) & 3
    code = code[:target.size]
    target[code == 1] += np.float32(threshold)
    target[code == 2] -= np.float32(threshold)
    return target


class ThresholdCodec:
    """Sparse threshold gradient codec with residual state (reference
    ``EncodedGradientsAccumulator`` wire format; JAX
    ``native/__init__.py:131``), with the same input checks: a gradient of
    the wrong size, a short bitmap buffer and a target of the wrong dtype or
    size raise ``ValueError``. ``plain=True`` runs the numpy versions."""

    def __init__(self, size: int, threshold: float = 1e-3, plain: bool = False):
        self.size = int(size)
        self.threshold = float(threshold)
        self.plain = bool(plain)
        self.residual = np.zeros(self.size, np.float32)

    def _check_grad(self, grad) -> np.ndarray:
        grad = np.ascontiguousarray(grad, np.float32).reshape(-1)
        if grad.size != self.size:
            raise ValueError(f"grad has {grad.size} elements, codec expects {self.size}")
        return grad

    def _check_target(self, target: Optional[np.ndarray]) -> np.ndarray:
        if target is None:
            return np.zeros(self.size, np.float32)
        if (target.dtype != np.float32 or target.ndim != 1 or target.size != self.size
                or not target.flags.c_contiguous):
            raise ValueError(f"target must be a contiguous 1-D float32 array of {self.size} "
                             f"elements, got {target.dtype}{target.shape}")
        return target

    def encode(self, grad) -> np.ndarray:
        grad = self._check_grad(grad)
        if self.plain:
            enc, self.residual = encode_plain(grad, self.residual, np.float32(self.threshold))
            return enc
        out = np.empty(self.size, np.int32)
        if not self.size:
            return out
        n = get_lib().threshold_encode(_ptr(grad, ctypes.c_float),
                                       _ptr(self.residual, ctypes.c_float), self.size,
                                       self.threshold, _ptr(out, ctypes.c_int32), self.size)
        return out[:n].copy()

    def decode(self, encoded, target: Optional[np.ndarray] = None) -> np.ndarray:
        target = self._check_target(target)
        encoded = np.ascontiguousarray(encoded, np.int32).reshape(-1)
        if not len(encoded):
            return target
        if self.plain:
            return decode_plain(encoded, np.float32(self.threshold), target)
        get_lib().threshold_decode(_ptr(encoded, ctypes.c_int32), len(encoded),
                                   self.threshold, _ptr(target, ctypes.c_float), self.size)
        return target

    def count(self, grad) -> int:
        """Elements the next encode of ``grad`` would emit; the residual is
        left as it is."""
        grad = self._check_grad(grad)
        if self.plain or not self.size:
            return count_plain(grad, self.residual, np.float32(self.threshold))
        return int(get_lib().threshold_count(_ptr(grad, ctypes.c_float),
                                             _ptr(self.residual, ctypes.c_float),
                                             self.size, self.threshold))

    def bitmap_nbytes(self) -> int:
        """Wire size of a bitmap encoding: 2 bits per element."""
        return (self.size + 3) // 4

    def encode_bitmap(self, grad) -> np.ndarray:
        grad = self._check_grad(grad)
        if self.plain:
            out, self.residual = bitmap_encode_plain(grad, self.residual,
                                                     np.float32(self.threshold))
            return out
        out = np.empty(self.bitmap_nbytes(), np.uint8)
        if self.size:
            get_lib().bitmap_encode(_ptr(grad, ctypes.c_float),
                                    _ptr(self.residual, ctypes.c_float), self.size,
                                    self.threshold, _ptr(out, ctypes.c_uint8))
        return out

    def decode_bitmap(self, encoded, target: Optional[np.ndarray] = None) -> np.ndarray:
        target = self._check_target(target)
        encoded = np.ascontiguousarray(encoded, np.uint8).reshape(-1)
        if len(encoded) < self.bitmap_nbytes():
            raise ValueError(f"bitmap buffer has {len(encoded)} bytes, need "
                             f"{self.bitmap_nbytes()} for {self.size} elements")
        if not self.size:
            return target
        if self.plain:
            return bitmap_decode_plain(encoded, np.float32(self.threshold), target)
        get_lib().bitmap_decode(_ptr(encoded, ctypes.c_uint8), self.size, self.threshold,
                                _ptr(target, ctypes.c_float))
        return target


class TreeCodec:
    """The threshold codec over a flattened parameter tree (JAX
    ``native/__init__.py:281``): ``flatten``/``unflatten`` between a list of
    leaves and one float32 vector, one residual over the whole tree, and
    ``encode`` choosing the sparse or the bitmap format by predicted wire
    size before either encoder touches the residual."""

    FORMAT_DENSE = 0
    FORMAT_SPARSE = 1
    FORMAT_BITMAP = 2

    def __init__(self, leaves, threshold: float = 1e-3, plain: bool = False):
        self.shapes = [tuple(np.shape(l)) for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.cumsum([0] + self.sizes)
        self.size = int(self.offsets[-1])
        self.threshold = float(threshold)
        self.codec = ThresholdCodec(self.size, self.threshold, plain=plain)

    @property
    def residual(self) -> np.ndarray:
        return self.codec.residual

    @residual.setter
    def residual(self, value) -> None:
        value = np.ascontiguousarray(value, np.float32).reshape(-1)
        if value.size != self.size:
            raise ValueError(f"residual has {value.size} elements, codec expects {self.size}")
        self.codec.residual = value

    def flatten(self, leaves) -> np.ndarray:
        if len(leaves) != len(self.sizes):
            raise ValueError(f"tree has {len(leaves)} leaves, codec expects {len(self.sizes)}")
        out = np.empty(self.size, np.float32)
        for i, (leaf, lo, sz) in enumerate(zip(leaves, self.offsets, self.sizes)):
            flat = np.asarray(leaf, np.float32).reshape(-1)
            if flat.size != sz:
                raise ValueError(f"leaf {i} has {flat.size} elements, template slot holds {sz}")
            out[lo:lo + sz] = flat
        return out

    def unflatten(self, flat) -> List[np.ndarray]:
        flat = np.ascontiguousarray(flat, np.float32).reshape(-1)
        if flat.size != self.size:
            raise ValueError(f"flat vector has {flat.size} elements, codec expects {self.size}")
        return [flat[lo:lo + sz].reshape(shape)
                for lo, sz, shape in zip(self.offsets, self.sizes, self.shapes)]

    def predicted_format(self, flat) -> int:
        n_hits = self.codec.count(flat)
        return (self.FORMAT_SPARSE if n_hits * 4 <= self.codec.bitmap_nbytes()
                else self.FORMAT_BITMAP)

    def encode(self, flat):
        fmt = self.predicted_format(flat)
        if fmt == self.FORMAT_SPARSE:
            return fmt, self.codec.encode(flat).tobytes()
        return fmt, self.codec.encode_bitmap(flat).tobytes()

    def decode_into(self, fmt: int, payload: bytes, target: np.ndarray) -> np.ndarray:
        if fmt == self.FORMAT_SPARSE:
            return self.codec.decode(np.frombuffer(payload, np.int32), target)
        if fmt == self.FORMAT_BITMAP:
            return self.codec.decode_bitmap(np.frombuffer(payload, np.uint8), target)
        raise ValueError(f"unknown encoded-update format {fmt}")


__all__ = ["ThresholdCodec", "TreeCodec", "NativeBuildError", "get_lib", "library_path",
           "encode_plain", "decode_plain", "bitmap_encode_plain", "bitmap_decode_plain"]
