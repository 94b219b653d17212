"""Fused inverted dropout (with an optional residual add), as one CUDA kernel
for Hopper used by both passes.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_dropout.py``: ``_call``
(the ``pallas_call`` at :124, running ``_fwd_kernel`` :55 or ``_bwd_kernel``
:66) becomes ``csrc/dropout.cu``. Over the tensor taken as flat elements:

- forward: ``y = x + where(bits < thresh, h * inv_keep, 0)``, ``x``
  optional (``fused_dropout`` has none);
- backward: ``dh = where(bits < thresh, gy * inv_keep, 0)`` from the same
  bits, drawn again, and ``dx = gy``. Only the seed is saved: the mask never
  exists in device memory in either pass.

``thresh = min(int(keep * 2**32), 2**32 - 1)`` (JAX ``_thresh``; 3865470566
at rate 0.1, and 4294967295 at rate 0, which drops an element with
probability 2**-32 and so is not the identity), compared unsigned.
``h * inv_keep`` is computed in ``h``'s dtype with ``inv_keep = 1 / keep``
rounded to that dtype first (in bf16 at rate 0.1 a kept value is
``h * 1.109375``), and the residual is added to the rounded product. Rate 1
raises, as ``1.0 / keep`` does in the JAX package.

Random bits: Philox4x32-10 (Salmon et al., SC'11; the Random123 constants
``M = (0xD2511F53, 0xCD9E8D57)``, ``W = (0x9E3779B9, 0xBB67AE85)``), with

    key     = (seed mod 2**32, 0)              the int32 seed's bit pattern
    counter = (j mod 2**32, j >> 32, 0, 0)     j = i // 4
    bits[i] = word (i % 4) of philox4x32_10(counter, key)

for element ``i`` of the flat tensor. The bits of an element depend on its
index and the seed alone, not on the launch grid, so the plain version below
(:func:`philox4x32_10` in int64 tensor arithmetic) reproduces the kernel's
bits exactly and the card's check against it is bitwise. They are not the
TPU's bits (``pltpu.prng_*`` cannot be reproduced off the TPU) nor those of
the JAX package's interpret-mode stand-in (``_ref_bits``): masks agree with
the JAX package in distribution, and kept values agree bit for bit.

:func:`fused_dropout_add` and :func:`fused_dropout` launch the kernel for CUDA
tensors (float32 or bfloat16; anything else raises) and take
:func:`fused_dropout_reference` only for CPU tensors. A call that autograd
records goes through :class:`FusedDropoutFunction`. No layer routes here:
the layers draw their masks with ``keep_mask``, as the JAX package's do
(``nn/base.py:52``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import (LaunchCounter,
                                                          NativeLibrary,
                                                          register_library)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

counter = LaunchCounter("fused_dropout")  # forward launches
bwd_counter = LaunchCounter("fused_dropout_bwd")  # backward launches (the same kernel on gy)


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    # (dtype, h, x, y, n, seed, thresh, inv_keep, stream)
    lib.dl4j_dropout.argtypes = [ctypes.c_int, p, p, p, ctypes.c_longlong, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_float, p]
    lib.dl4j_dropout.restype = ctypes.c_int
    lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = register_library(NativeLibrary("dropout.cu", _declare))

Seed = Union[int, torch.Tensor]


def threshold(rate: float) -> int:
    """The keep threshold on 32 random bits (JAX ``_thresh``); rate in [0, 1)."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


@functools.lru_cache(maxsize=64)
def inv_keep(rate: float, dtype: torch.dtype) -> float:
    """``1 / (1 - rate)`` rounded to ``dtype``, as the kernel multiplies by it
    (cached: the rounding goes through a tensor, which costs host time on
    every launch otherwise)."""
    threshold(rate)
    return float(torch.tensor(1.0 / (1.0 - float(rate)), dtype=torch.float64).to(dtype))


def seed_bits(seed: Seed) -> int:
    """The seed's 32-bit pattern (a negative int32 seed is taken mod 2**32)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype.is_floating_point:
            raise TypeError(f"the seed is one integer, got {seed.dtype} {tuple(seed.shape)}")
        seed = int(seed.reshape(()).item())
    return int(seed) & _MASK32


def seed_from_key(generator: torch.Generator) -> torch.Tensor:
    """One int32 seed drawn from ``generator`` (JAX ``seed_from_key``, which
    folds a PRNG key down to the kernel's scalar seed); taped, as
    ``keep_mask``'s draws are."""
    from deeplearning4j_tpu_torch.runtime.rng import taped
    return taped(lambda: torch.randint(-2 ** 31, 2 ** 31, (), generator=generator,
                                       dtype=torch.int64,
                                       device=generator.device).to(torch.int32))


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``m * c`` (m < 2**32, c an int64 tensor
    of values < 2**32), in int64 arithmetic that never overflows."""
    p_lo = m * (c & 0xFFFF)  # < 2**48
    p_hi = m * (c >> 16)  # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) of 32-bit values: the four
    output words, as int64 tensors of values in [0, 2**32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3))
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(n: int, seed: Seed, device=None) -> torch.Tensor:
    """The kernel's 32 random bits of each of ``n`` flat elements, int64."""
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(j & _MASK32, j >> 32, torch.zeros_like(j), torch.zeros_like(j),
                          seed_bits(seed), 0)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_mask(n: int, seed: Seed, rate: float, device=None) -> torch.Tensor:
    """The flat boolean mask of kept elements (``bits < thresh``)."""
    return dropout_bits(n, seed, device) < threshold(rate)


def fused_dropout_reference(x: Optional[torch.Tensor], h: torch.Tensor, seed: Seed,
                            rate: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x + where(kept, h * inv_keep,
    0)`` in ``h``'s dtype, ``x`` optional; the backward is this with
    ``x = None`` applied to ``gy``."""
    kept = keep_mask(h.numel(), seed, rate, h.device).reshape(h.shape)
    scale = torch.tensor(inv_keep(rate, h.dtype), dtype=h.dtype, device=h.device)
    y = torch.where(kept, h * scale, torch.zeros((), dtype=h.dtype, device=h.device))
    return y if x is None else x + y


def _check(x, h) -> None:
    if x is not None:
        if tuple(x.shape) != tuple(h.shape) or x.dtype != h.dtype:
            raise ValueError(f"x {tuple(x.shape)} {x.dtype} and h {tuple(h.shape)} {h.dtype} "
                             "must share shape and dtype")
        if x.device != h.device:
            raise ValueError(f"x is on {x.device}, h on {h.device}")
    if not h.dtype.is_floating_point:
        raise TypeError(f"dropout takes floating-point tensors, got {h.dtype}")
    if h.device.type == "cpu":
        return
    if h.device.type != "cuda":
        raise ValueError(f"fused dropout runs on CUDA or CPU tensors, got {h.device}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {h.dtype}")


def launch_dropout(x: Optional[torch.Tensor], h: torch.Tensor, seed: Seed, rate: float,
                   launches: LaunchCounter) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by :func:`_check`:
    returns ``x + where(kept, h * inv_keep, 0)`` (``x`` may be None) in a
    new tensor shaped as ``h``."""
    lib = LIBRARY.load()
    h = h.contiguous()
    x = None if x is None else x.contiguous()
    y = torch.empty_like(h, memory_format=torch.contiguous_format)
    if h.numel():
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            err = lib.dl4j_dropout(_DTYPE_CODES[h.dtype], h.data_ptr(),
                                   None if x is None else x.data_ptr(), y.data_ptr(), h.numel(),
                                   seed_bits(seed), threshold(rate), inv_keep(rate, h.dtype),
                                   stream)
        if err != 0:
            msg = lib.dl4j_cuda_error_string(err).decode()
            raise RuntimeError(f"dropout kernel launch failed: {msg} (cudaError {err}) at "
                               f"{tuple(h.shape)} {h.dtype} rate={rate}")
    launches.add()
    return y


def _apply(x, h, seed, rate, launches):
    if h.device.type == "cpu":
        return fused_dropout_reference(x, h, seed, rate)
    return launch_dropout(x, h, seed, rate, launches)


class FusedDropoutFunction(torch.autograd.Function):
    """Fused dropout under autograd (JAX ``fused_dropout_add`` with its
    custom VJP). Saves only the seed; the backward launches the same kernel
    on ``gy`` without ``x`` (the plain version on CPU tensors), returns
    ``dx = gy`` itself, and no gradient for the seed or the rate."""

    @staticmethod
    def forward(ctx, x, h, seed, rate):
        ctx.seed, ctx.rate = seed_bits(seed), float(rate)
        return _apply(x, h, ctx.seed, ctx.rate, counter)

    @staticmethod
    def backward(ctx, gy):
        dh = _apply(None, gy, ctx.seed, ctx.rate, bwd_counter)
        return (gy if ctx.needs_input_grad[0] else None), dh, None, None


def fused_dropout_add(x: Optional[torch.Tensor], h: torch.Tensor, seed: Seed,
                      rate: float) -> torch.Tensor:
    """``x + inverted_dropout(h, rate)`` (``x`` may be None). ``seed`` is an
    int32 (a Python int or a one-element integer tensor, e.g. from
    :func:`seed_from_key`): the same seed gives the same mask, forward and
    backward. CUDA tensors launch the kernel (or the call raises); CPU
    tensors take the plain version. Differentiable in x and h."""
    _check(x, h)
    threshold(rate)
    if torch.is_grad_enabled() and (h.requires_grad or (x is not None and x.requires_grad)):
        return FusedDropoutFunction.apply(x, h, seed_bits(seed), float(rate))
    return _apply(x, h, seed, rate, counter)


def fused_dropout(h: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Plain fused inverted dropout (no residual)."""
    return fused_dropout_add(None, h, seed, rate)
