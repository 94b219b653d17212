"""Persistent fused GRU (reset-after cell) as CUDA kernels for Hopper, forward
and backward.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_gru.py``: ``_gru_fwd``
(the ``pallas_call`` at :147) and ``_gru_bwd_kernel_call`` (:224). The input
projection ``x @ W + b`` for the whole sequence stays outside the kernels
(one ``torch.matmul``). The forward source, ``csrc/gru_fwd.cu``, runs the
sequential recurrence with the gate columns of ``W_rec`` pinned in shared
memory for all steps and the h carry in fp32; its training instance also
saves the residuals the backward reads: the activated gates (T, B, 3H) and
the recurrent n pre-activation ``zh_n`` (T, B, H). The backward source,
``csrc/gru_bwd.cu``, runs the reverse-time recurrence and writes ``dzx`` and
``dh0``; ``dW_rec = h_prev^T @ ds_rec`` is a large product outside it, as at
JAX ``fused_gru.py:272-283``. Both sources state their bounds and designs.
Each holds two kernels, and its C entry point picks one, as the LSTM's do
(:mod:`.fused_lstm`): bf16 with H % 8 == 0 and 16-byte aligned operands
takes the row-group kernel (tensor-core step products, a barrier per group
of 16 batch rows, whose counters the wrapper hands it zeroed); float32, the
other bf16 shapes, and a shape whose row-group plan does not fit take the
CUDA-core kernel (a grid barrier a step).

Gate order [r, u, n] (reset, update, new)::

    zh  = h @ W_rec
    r   = sigmoid(zx_r + zh_r)
    u   = sigmoid(zx_u + zh_u)
    n   = tanh(zx_n + r * zh_n)
    h'  = (1 - u) * n + u * h

Rounding points, as in the Pallas kernels: h is carried in fp32 and rounded
to the input dtype before the recurrent product (which is exactly ``ys[t-1]``),
whose products are summed in fp32; ys, hT, the residuals, dzx and dh0 are
stored in the input dtype. The backward reads ``h_prev`` from ``ys[t-1]`` (or
``h0``), carries dh in fp32, and feeds the product ``round(ds_r)``,
``round(du)`` and ``round(da * r)`` (da unrounded); ``dW_rec`` rebuilds
``ds_rec`` from the rounded ``dzx`` and ``r`` in fp32, rounds it, sums in
fp32 and rounds to ``W_rec``'s dtype.

:func:`fused_gru` launches the kernels for CUDA tensors and raises on what
they do not take. With no input that needs a gradient (serving, under
``torch.inference_mode``) it launches the inference instance of the forward;
otherwise it goes through :class:`FusedGRUFunction`, whose forward launches
the saving instance and whose backward launches the backward kernel. Only
CPU tensors take the plain PyTorch versions, :func:`gru_reference` and
:func:`gru_bwd_reference`, which have the same rounding points.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import (LaunchCounter,
                                                          NativeLibrary,
                                                          register_library)
from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import (_DTYPE_CODES,
                                                             _check_same,
                                                             _counters,
                                                             _launch_by_rows,
                                                             _math_dtype,
                                                             needs_grad)

counter = LaunchCounter("fused_gru")  # forward, inference instance
save_counter = LaunchCounter("fused_gru_save")  # forward, saving residuals
bwd_counter = LaunchCounter("fused_gru_bwd")


def _declare_fwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_gru_fwd.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dl4j_gru_fwd.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_gru_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dl4j_gru_bwd.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = register_library(NativeLibrary("gru_fwd.cu", _declare_fwd))
BWD_LIBRARY = register_library(NativeLibrary("gru_bwd.cu", _declare_bwd))


def gru_reference(zx: torch.Tensor, w_rec: torch.Tensor, h0: torch.Tensor,
                  save: bool = False):
    """Plain time loop of the forward kernel's function: the same rounding
    points, one step at a time. Returns ``(ys, hT)``, and with ``save`` also
    the residuals ``(gates, zh_n)``."""
    hid = zx.shape[2] // 3
    dt = zx.dtype
    ct = _math_dtype(dt)
    w = w_rec.to(ct)
    h = h0.to(ct)
    ys, gates, zhns = [], [], []
    for t in range(zx.shape[0]):
        z = zx[t].to(ct)
        zh = h.to(dt).to(ct) @ w
        r = torch.sigmoid(z[:, :hid] + zh[:, :hid])
        u = torch.sigmoid(z[:, hid:2 * hid] + zh[:, hid:2 * hid])
        zh_n = zh[:, 2 * hid:]
        n = torch.tanh(z[:, 2 * hid:] + r * zh_n)
        h = (1.0 - u) * n + u * h
        ys.append(h.to(dt))
        if save:
            gates.append(torch.cat([r, u, n], dim=1).to(dt))
            zhns.append(zh_n.to(dt))
    out = (torch.stack(ys), h.to(dt))
    return out + (torch.stack(gates), torch.stack(zhns)) if save else out


def _h_prev(ys: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h entering each step: h0, then ys[:-1] (both in the input dtype)."""
    return torch.cat([h0[None], ys[:-1]], dim=0)


def gru_bwd_reference(dys: torch.Tensor, dhT: torch.Tensor, gates: torch.Tensor,
                      zhn: torch.Tensor, ys: torch.Tensor, h0: torch.Tensor,
                      w_rec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain reverse-time loop of the backward kernel's function, with its
    rounding points: reads the residuals of :func:`gru_reference`
    (``save=True``) and its ``ys``; returns ``(dzx, dh0)`` in the input
    dtype."""
    hid = gates.shape[2] // 3
    dt = gates.dtype
    ct = _math_dtype(dt)
    w_t = w_rec.to(ct).t()  # (3H, H)
    h_prev = _h_prev(ys, h0)
    dh = dhT.to(ct)
    dzx = [None] * gates.shape[0]
    for t in reversed(range(gates.shape[0])):
        g = gates[t].to(ct)
        r, u, n = g[:, :hid], g[:, hid:2 * hid], g[:, 2 * hid:]
        dh = dh + dys[t].to(ct)
        du = dh * (h_prev[t].to(ct) - n) * u * (1.0 - u)
        da = dh * (1.0 - u) * (1.0 - n * n)
        ds_r = da * zhn[t].to(ct) * r * (1.0 - r)
        dzx[t] = torch.cat([ds_r, du, da], dim=1).to(dt)
        # the three thirds' products, summed in the Pallas kernel's order
        dh = (dh * u + dzx[t][:, :hid].to(ct) @ w_t[:hid]
              + dzx[t][:, hid:2 * hid].to(ct) @ w_t[hid:2 * hid]
              + (da * r).to(dt).to(ct) @ w_t[2 * hid:])
    return torch.stack(dzx), dh.to(dt)


def gru_param_grads(dzx: torch.Tensor, ys: torch.Tensor, h0: torch.Tensor,
                    gates: torch.Tensor, w_rec: torch.Tensor) -> torch.Tensor:
    """The gradient the JAX package takes outside its backward kernel
    (``fused_gru.py:272-283``): ``ds_rec`` rebuilt from the rounded ``dzx``
    (its n-third times the reset gate, in fp32, rounded), then
    ``dW_rec = h_prev^T @ ds_rec`` over all (t, b), summed in fp32 and
    rounded to ``W_rec``'s dtype."""
    hid = ys.shape[2]
    dt = dzx.dtype
    ct = _math_dtype(dt)
    n_third = (dzx[..., 2 * hid:].to(ct) * gates[..., :hid].to(ct)).to(dt)
    ds_rec = torch.cat([dzx[..., :2 * hid], n_third], dim=-1).reshape(-1, 3 * hid)
    h_prev = _h_prev(ys, h0).reshape(-1, hid)
    return (h_prev.to(ct).t() @ ds_rec.to(ct)).to(w_rec.dtype)


def _check(zx, w_rec, h0) -> None:
    """Raise on anything the forward kernel does not take."""
    if zx.dim() != 3:
        raise ValueError(f"zx must be (T, B, 3H), got {tuple(zx.shape)}")
    t_len, b, h3 = zx.shape
    if h3 % 3 or t_len < 1 or b < 1 or h3 < 3:
        raise ValueError(f"zx must be (T, B, 3H) with T, B, H >= 1, got {tuple(zx.shape)}")
    hid = h3 // 3
    _check_same({"zx": zx, "w_rec": w_rec, "h0": h0},
                {"w_rec": (hid, h3), "h0": (b, hid)}, zx)


def _check_bwd(dys, dhT, gates, zhn, ys, h0, w_rec) -> None:
    """Raise on anything the backward kernel does not take."""
    if gates.dim() != 3 or gates.shape[2] % 3 or gates.shape[2] < 3:
        raise ValueError(f"gates must be (T, B, 3H), got {tuple(gates.shape)}")
    t_len, b, h3 = gates.shape
    hid = h3 // 3
    tensors = {"dys": dys, "dhT": dhT, "gates": gates, "zhn": zhn, "ys": ys, "h0": h0,
               "w_rec": w_rec}
    shapes = {"dys": (t_len, b, hid), "dhT": (b, hid), "zhn": (t_len, b, hid),
              "ys": (t_len, b, hid), "h0": (b, hid), "w_rec": (hid, h3)}
    _check_same(tensors, shapes, gates)


def launch_gru_fwd(zx, w_rec, h0, launches: LaunchCounter, save: bool = False):
    """Launch the forward kernel on CUDA tensors already checked by
    :func:`_check`. Returns ``(ys, hT)``; with ``save`` (the training
    instance) also the residuals ``(gates, zh_n)``."""
    lib = LIBRARY.load()
    t_len, b, h3 = zx.shape
    hid = h3 // 3
    new = lambda *shape: torch.empty(shape, dtype=zx.dtype, device=zx.device)  # noqa: E731
    ys, h_t = new(t_len, b, hid), new(b, hid)
    gates, zhn = (new(t_len, b, h3), new(t_len, b, hid)) if save else (None, None)
    counters = _counters(b, zx)
    args = (_DTYPE_CODES[zx.dtype], zx.data_ptr(), w_rec.data_ptr(), h0.data_ptr(),
            ys.data_ptr(), h_t.data_ptr(), None if gates is None else gates.data_ptr(),
            None if zhn is None else zhn.data_ptr(), counters.data_ptr(), t_len, b, hid)
    _launch_by_rows(lib, lib.dl4j_gru_fwd, args, b, launches, "GRU forward", zx)
    return (ys, h_t, gates, zhn) if save else (ys, h_t)


def launch_gru_bwd(dys, dhT, gates, zhn, ys, h0, w_rec, launches: LaunchCounter):
    """Launch the backward kernel on CUDA tensors already checked by
    :func:`_check_bwd`. Returns ``(dzx, dh0)``."""
    lib = BWD_LIBRARY.load()
    t_len, b, h3 = gates.shape
    dzx = torch.empty_like(gates)
    dh0 = torch.empty_like(h0)
    scratch = torch.empty((2, b, h3 // 3), dtype=gates.dtype, device=gates.device)
    counters = _counters(b, gates)
    args = (_DTYPE_CODES[gates.dtype], dys.data_ptr(), dhT.data_ptr(), gates.data_ptr(),
            zhn.data_ptr(), ys.data_ptr(), h0.data_ptr(), w_rec.data_ptr(), dzx.data_ptr(),
            dh0.data_ptr(), scratch.data_ptr(), counters.data_ptr(), t_len, b, h3 // 3)
    _launch_by_rows(lib, lib.dl4j_gru_bwd, args, b, launches, "GRU backward", gates)
    return dzx, dh0


class FusedGRUFunction(torch.autograd.Function):
    """Differentiable recurrence, the counterpart of the JAX ``custom_vjp``
    (``fused_gru.py:254-286``): the forward launches the saving instance,
    the backward the backward kernel plus the ``dW_rec`` product. CPU
    tensors take the plain versions."""

    @staticmethod
    def forward(ctx, zx, w_rec, h0):
        if zx.device.type == "cpu":
            ys, h_t, gates, zhn = gru_reference(zx, w_rec, h0, save=True)
        else:
            ys, h_t, gates, zhn = launch_gru_fwd(zx, w_rec, h0, save_counter, save=True)
        ctx.save_for_backward(ys, gates, zhn, w_rec, h0)
        return ys, h_t

    @staticmethod
    def backward(ctx, dys, dhT):
        ys, gates, zhn, w_rec, h0 = ctx.saved_tensors
        args = (dys.contiguous(), dhT.contiguous(), gates, zhn, ys, h0, w_rec)
        _check_bwd(*args)
        if gates.device.type == "cpu":
            dzx, dh0 = gru_bwd_reference(*args)
        else:
            dzx, dh0 = launch_gru_bwd(*args, bwd_counter)
        return dzx, gru_param_grads(dzx, ys, h0, gates, w_rec), dh0


def fused_gru(zx: torch.Tensor, w_rec: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the recurrence. ``zx`` is the hoisted input projection
    ``x @ W + b`` laid out (T, B, 3H); returns ``(ys, hT)`` with ys
    (T, B, H), both in zx's dtype, differentiable in zx, w_rec and h0. CUDA
    tensors launch the kernels (or the call raises); CPU tensors take the
    plain versions."""
    _check(zx, w_rec, h0)
    if needs_grad(zx, w_rec, h0):
        return FusedGRUFunction.apply(zx, w_rec, h0)
    if zx.device.type == "cpu":
        return gru_reference(zx, w_rec, h0)
    return launch_gru_fwd(zx, w_rec, h0, counter)
