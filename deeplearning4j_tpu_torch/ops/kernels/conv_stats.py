"""1x1 convolution as a product with BatchNormalization's batch statistics
in its epilogue, as one CUDA kernel for Hopper.

Counterpart of the one TPU kernel of the JAX repository outside the package,
``experiments/resnet_megakernel_stage4.py`` ``pallas_conv_stats`` (the
``pallas_call`` at :64, body ``kernel`` at :46-62), which becomes
``csrc/conv_stats.cu``. On ``x2d`` (M, K) and ``w`` (K, N)::

    acc = x2d @ w                          f32 accumulator
    y   = acc rounded to x2d's dtype       (M, N)
    s1  = sum over rows of (acc - shift)   (N,) f32
    s2  = sum over rows of (acc - shift)^2 (N,) f32

``shift`` (N,) f32 or None (zero: the Pallas function exactly). The
``ComputationGraph`` passes a ``BatchNormalization``'s running mean, so that
``mean = shift + s1/n`` and ``var = max(s2/n - (s1/n)^2, 0)`` are the
shifted single-pass statistics of the JAX package's
``nn/conv_layers.py:241-250``, taken from the accumulator before ``y`` is
rounded. A 1x1 convolution with stride (sh, sw) and no padding is this
product on ``x[:, ::sh, ::sw, :]`` as (M, K) rows and ``W[0, 0]``.

:func:`conv_stats` launches the kernel for CUDA tensors (float32 or
bfloat16; anything else raises) and takes :func:`conv_stats_reference` only
for CPU tensors. Under autograd it runs as :class:`ConvStatsFunction`: the
forward is the kernel, and the backward forms ``g = dy + ds1 + 2 (y -
shift) ds2`` and the two products ``dx = g @ w^T`` and ``dw = x2d^T @ g``
with ``torch.matmul``, as XLA forms them outside any Pallas kernel in the
JAX package. ``shift`` gets no gradient: in JAX it is layer state.

Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at row 13's shape (12544,
2048) @ (2048, 512) bf16 the 26.3 GFLOP take 0.0266 ms and bound it; at
stage 0 of ResNet-50 (K = 64) the bytes of x and y do.

The C side picks the kernel from the dtype and the alignment alone: bf16
with K % 8 == 0, N % 8 == 0 and 16-byte-aligned x, w and y (every ResNet-50
pair) runs ``conv_stats_wgmma_kernel`` (TMA-fed shared-memory rings,
``wgmma`` on the tensor cores, a persistent walk over the output tiles);
float32 and other bf16 inputs run ``conv_stats_kernel``. Either writes one
partial row of the two sums per 128-row block of x, which a second kernel
adds in a fixed order, so two launches agree bit for bit. The design and
its times on the card are in the source's header.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import (LaunchCounter,
                                                          NativeLibrary,
                                                          register_library)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = LaunchCounter("conv_stats")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # (dtype, x, w, shift, y, part1, part2, s1, s2, M, K, N, stream)
    lib.dl4j_conv_stats.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.dl4j_conv_stats.restype = i
    lib.dl4j_conv_stats_blocks.argtypes = [i]
    lib.dl4j_conv_stats_blocks.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = register_library(NativeLibrary("conv_stats.cu", _declare))

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator's dtype: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def conv_stats_reference(x2d: torch.Tensor, w: torch.Tensor,
                         shift: Optional[torch.Tensor] = None) -> Stats:
    """Plain PyTorch version of the kernel: ``(y, s1, s2)``."""
    ct = _acc_dtype(x2d.dtype)
    acc = x2d.to(ct) @ w.to(ct)
    d = acc if shift is None else acc - shift.to(ct)
    return acc.to(x2d.dtype), d.sum(0), (d * d).sum(0)


def _check(x2d, w, shift) -> None:
    if x2d.dim() != 2 or w.dim() != 2 or x2d.shape[1] != w.shape[0]:
        raise ValueError(f"conv_stats takes x2d (M, K) and w (K, N), got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if x2d.dtype != w.dtype or not x2d.dtype.is_floating_point:
        raise TypeError(f"x2d and w must share one floating dtype, got {x2d.dtype} and "
                        f"{w.dtype}")
    if x2d.shape[1] == 0:
        raise ValueError("conv_stats takes K >= 1 input channels")
    if shift is not None and tuple(shift.shape) != (w.shape[1],):
        raise ValueError(f"shift must be ({w.shape[1]},), got {tuple(shift.shape)}")
    devices = {t.device for t in (x2d, w, shift) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"conv_stats' tensors lie on several devices: {devices}")
    if x2d.device.type == "cpu":
        return
    if x2d.device.type != "cuda":
        raise ValueError(f"conv_stats runs on CUDA or CPU tensors, got {x2d.device}")
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x2d.dtype}")
    if shift is not None and shift.dtype != torch.float32:
        raise TypeError(f"the kernel's shift is float32, got {shift.dtype}")
    if x2d.shape[0] >= 2 ** 31 or x2d.shape[1] >= 2 ** 31 or w.shape[1] >= 2 ** 31:
        raise ValueError(f"conv_stats takes dimensions below 2**31, got "
                         f"{tuple(x2d.shape)} @ {tuple(w.shape)}")


def launch_conv_stats(x2d: torch.Tensor, w: torch.Tensor, shift: Optional[torch.Tensor],
                      launches: LaunchCounter = counter) -> Stats:
    """Launch the kernel on CUDA tensors already checked by :func:`_check`:
    ``(y, s1, s2)`` in new tensors."""
    lib = LIBRARY.load()
    x2d, w = x2d.contiguous(), w.contiguous()
    shift = None if shift is None else shift.contiguous()
    (m, k), n = x2d.shape, w.shape[1]
    y = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    # the column-sum kernel writes every column; no rows: zero sums, no launch
    new = torch.empty if m else torch.zeros
    s1, s2 = (new(n, dtype=torch.float32, device=x2d.device) for _ in range(2))
    if m and n:
        part = torch.empty((2, lib.dl4j_conv_stats_blocks(m), n), dtype=torch.float32,
                           device=x2d.device)
        with torch.cuda.device(x2d.device):
            stream = torch.cuda.current_stream(x2d.device).cuda_stream
            err = lib.dl4j_conv_stats(_DTYPE_CODES[x2d.dtype], x2d.data_ptr(), w.data_ptr(),
                                      None if shift is None else shift.data_ptr(),
                                      y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                                      s1.data_ptr(), s2.data_ptr(), m, k, n, stream)
        if err != 0:
            msg = lib.dl4j_cuda_error_string(err).decode()
            raise RuntimeError(f"conv_stats kernel launch failed: {msg} (cudaError {err}) at "
                               f"({m}, {k}) @ ({k}, {n}) {x2d.dtype}")
        launches.add()
    return y, s1, s2  # no rows or no columns: empty sums, nothing launched


def _apply(x2d, w, shift) -> Stats:
    if x2d.device.type == "cpu":
        return conv_stats_reference(x2d, w, shift)
    return launch_conv_stats(x2d, w, shift)


class ConvStatsFunction(torch.autograd.Function):
    """:func:`conv_stats` under autograd. Saves ``x2d``, ``w``, ``y`` and
    ``shift``; the backward is ``g = dy + ds1 + 2 (y - shift) ds2`` formed in
    float32 (float64 for float64 inputs), then ``dx = g @ w^T`` and ``dw =
    x2d^T @ g`` with ``g`` in the inputs' dtype. It uses ``y`` for the
    accumulator, which the forward rounded: in bf16 that is the rounding
    XLA's own backward sees."""

    @staticmethod
    def forward(ctx, x2d, w, shift):
        y, s1, s2 = _apply(x2d, w, shift)
        ctx.save_for_backward(x2d, w, y, shift)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x2d, w, y, shift = ctx.saved_tensors
        ct = _acc_dtype(x2d.dtype)
        g = torch.zeros(y.shape, dtype=ct, device=y.device) if dy is None else dy.to(ct)
        if ds1 is not None:
            g = g + ds1.to(ct)
        if ds2 is not None:
            d = y.to(ct) if shift is None else y.to(ct) - shift.to(ct)
            g = g + 2.0 * d * ds2.to(ct)
        g = g.to(x2d.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x2d.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw, None


def conv_stats(x2d: torch.Tensor, w: torch.Tensor,
               shift: Optional[torch.Tensor] = None) -> Stats:
    """``(y, s1, s2)`` of ``x2d @ w`` (see the module's docstring). CUDA
    tensors launch the kernel (or the call raises); CPU tensors take the
    plain version. Differentiable in ``x2d`` and ``w``."""
    _check(x2d, w, shift)
    if torch.is_grad_enabled() and (x2d.requires_grad or w.requires_grad):
        return ConvStatsFunction.apply(x2d, w, shift)
    return _apply(x2d, w, shift)
