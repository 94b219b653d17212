"""Persistent fused LSTM forward (plain cell) as a CUDA kernel for Hopper.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_lstm.py`` (``_lstm_fwd``,
the ``pallas_call`` at :162). The input projection ``x @ W + b`` for the
whole sequence stays outside the kernel (one ``torch.matmul``, as the JAX
package leaves it to XLA); the kernel runs the sequential recurrence with
the gate columns of ``W_rec`` pinned in shared memory for all steps and the
h/c carries in fp32. The kernel source, ``csrc/lstm_fwd.cu``, also serves
the peephole/mask cell of :mod:`.fused_lstm_graves` and states its bound.

Gate order [i, f, g, o]. Rounding points: the carries and the gate math are
fp32; h is rounded to the input dtype before the recurrent product, whose
products are summed in fp32; ys, hT and cT are stored in the input dtype.

:func:`fused_lstm` launches the kernel for CUDA tensors and raises on what
the kernel does not take. It uses :func:`fused_lstm_reference`, the plain
PyTorch version with the same rounding points, only for CPU tensors. The
backward kernel (TPU kernel #4) comes with training.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import (LaunchCounter,
                                                          NativeLibrary,
                                                          register_library)

# Batch rows handled by one launch; a larger batch is covered by one launch
# per group of rows (rows never interact, so the groups are independent).
ROWS_PER_LAUNCH = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = LaunchCounter("fused_lstm")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_lstm_fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dl4j_lstm_fwd.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = register_library(NativeLibrary("lstm_fwd.cu", _declare))


def lstm_reference(zx: torch.Tensor, w_rec: torch.Tensor,
                   peep: Optional[torch.Tensor], h0: torch.Tensor,
                   c0: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain time loop of the kernel's function (both cells): the same
    rounding points, one step at a time."""
    t_len, b, h4 = zx.shape
    hid = h4 // 4
    dt = zx.dtype
    w = w_rec.float()
    p = None if peep is None else peep.float()
    h = h0.float()
    c = c0.float()
    ys = torch.empty((t_len, b, hid), dtype=dt, device=zx.device)
    for t in range(t_len):
        z = zx[t].float() + h.to(dt).float() @ w
        zi, zf, zg, zo = z[:, :hid], z[:, hid:2 * hid], z[:, 2 * hid:3 * hid], z[:, 3 * hid:]
        if p is not None:
            zi = zi + c * p[:hid]
            zf = zf + c * p[hid:2 * hid]
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
        g = torch.tanh(zg)
        c_til = f * c + i * g
        if p is not None:
            zo = zo + c_til * p[2 * hid:]
        h_til = torch.sigmoid(zo) * torch.tanh(c_til)
        if mask is not None:
            m = mask[t].float()[:, None]
            h_til = m * h_til + (1.0 - m) * h
            c_til = m * c_til + (1.0 - m) * c
        h, c = h_til, c_til
        ys[t] = h.to(dt)
    return ys, h.to(dt), c.to(dt)


def fused_lstm_reference(zx, w_rec, h0, c0):
    """Plain PyTorch version of :func:`fused_lstm`."""
    return lstm_reference(zx, w_rec, None, h0, c0, None)


def _check(zx, w_rec, peep, h0, c0, mask) -> None:
    """Raise on anything the kernel does not take."""
    if zx.dim() != 3:
        raise ValueError(f"zx must be (T, B, 4H), got {tuple(zx.shape)}")
    t_len, b, h4 = zx.shape
    if h4 % 4 or t_len < 1 or b < 1 or h4 < 4:
        raise ValueError(f"zx must be (T, B, 4H) with T, B, H >= 1, got {tuple(zx.shape)}")
    hid = h4 // 4
    shapes = {"w_rec": (w_rec, (hid, h4)), "h0": (h0, (b, hid)), "c0": (c0, (b, hid))}
    if peep is not None:
        shapes["peep"] = (peep, (3 * hid,))
    if mask is not None:
        shapes["mask"] = (mask, (t_len, b))
    for name, (tensor, shape) in shapes.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(tensor.shape)}")
    tensors = {"zx": zx, **{k: v[0] for k, v in shapes.items()}}
    for name, tensor in tensors.items():
        if tensor.device != zx.device:
            raise ValueError(f"{name} is on {tensor.device}, zx on {zx.device}")
        if tensor.dtype != zx.dtype:
            raise TypeError(f"{name} is {tensor.dtype}, zx is {zx.dtype}")
    if zx.device.type == "cpu":
        return
    if zx.device.type != "cuda":
        raise ValueError(f"fused LSTM runs on CUDA or CPU tensors, got {zx.device}")
    if zx.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {zx.dtype}")
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_lstm_fwd(zx, w_rec, peep, h0, c0, mask, launches: LaunchCounter):
    """Launch the kernel on CUDA tensors already checked by :func:`_check`:
    one launch per group of ``ROWS_PER_LAUNCH`` batch rows, on the current
    stream."""
    lib = LIBRARY.load()
    t_len, b, h4 = zx.shape
    hid = h4 // 4
    ys = torch.empty((t_len, b, hid), dtype=zx.dtype, device=zx.device)
    h_t = torch.empty((b, hid), dtype=zx.dtype, device=zx.device)
    c_t = torch.empty((b, hid), dtype=zx.dtype, device=zx.device)
    with torch.cuda.device(zx.device):
        stream = torch.cuda.current_stream(zx.device).cuda_stream
        for r0 in range(0, b, ROWS_PER_LAUNCH):
            rows = min(ROWS_PER_LAUNCH, b - r0)
            err = lib.dl4j_lstm_fwd(
                _DTYPE_CODES[zx.dtype], zx.data_ptr(), w_rec.data_ptr(),
                None if peep is None else peep.data_ptr(), h0.data_ptr(),
                c0.data_ptr(), None if mask is None else mask.data_ptr(),
                ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(),
                t_len, b, hid, r0, rows, stream)
            if err != 0:
                msg = lib.dl4j_cuda_error_string(err).decode()
                raise RuntimeError(f"LSTM forward kernel launch failed: "
                                   f"{msg} (cudaError {err}) at T={t_len} "
                                   f"B={b} H={hid} {zx.dtype}")
            launches.add()
    return ys, h_t, c_t


def fused_lstm(zx: torch.Tensor, w_rec: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the recurrence. ``zx`` is the hoisted input projection
    ``x @ W + b`` laid out (T, B, 4H); returns ``(ys, hT, cT)`` with ys
    (T, B, H), all in zx's dtype. CUDA tensors launch the kernel (or the
    call raises); CPU tensors take :func:`fused_lstm_reference`."""
    _check(zx, w_rec, None, h0, c0, None)
    if zx.device.type == "cpu":
        return fused_lstm_reference(zx, w_rec, h0, c0)
    return launch_lstm_fwd(zx, w_rec, None, h0, c0, None, counter)
