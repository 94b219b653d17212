"""Persistent fused LSTM (plain cell) as CUDA kernels for Hopper, forward and
backward.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_lstm.py``: ``_lstm_fwd``
(the ``pallas_call`` at :162) and ``_lstm_bwd_kernel_call`` (:242). The input
projection ``x @ W + b`` for the whole sequence stays outside the kernels
(one ``torch.matmul``, as the JAX package leaves it to XLA). The forward
source, ``csrc/lstm_fwd.cu``, runs the sequential recurrence with the gate
columns of ``W_rec`` pinned in shared memory for all steps and the h/c
carries in fp32; its training instance also saves the residuals the
backward reads: the activated gates (T, B, 4H) and the carried cell
sequence (T, B, H). The backward source, ``csrc/lstm_bwd.cu``, runs the
reverse-time recurrence and writes ``ds`` (the pre-activation gradients,
which are also ``dzx``), ``dh0`` and ``dc0``; ``dW_rec = h_prev^T @ ds`` and
the peephole gradients are large products outside it, as at JAX
``fused_lstm.py:297-304``. Both sources also serve the peephole/mask cell of
:mod:`.fused_lstm_graves` and state their bounds. Each holds two kernels,
and its C entry point picks one: bf16 with H % 8 == 0 and 16-byte aligned
operands takes the row-group kernel (tensor-core step products, a barrier
per group of 16 batch rows, whose counters the wrapper hands it zeroed);
float32, the other bf16 shapes, and a shape whose row-group plan does not
fit take the CUDA-core kernel (a grid barrier a step).

Gate order [i, f, g, o]. Rounding points: the carries and the gate math are
fp32; h (forward) and ds (backward) are rounded to the input dtype before
the recurrent product, whose products are summed in fp32; ys, hT, cT, the
residuals, ds, dh0 and dc0 are stored in the input dtype; ``dW_rec`` is
summed in fp32 and rounded to ``W_rec``'s dtype.

:func:`fused_lstm` launches the kernels for CUDA tensors and raises on what
they do not take. With no input that needs a gradient (serving, under
``torch.inference_mode``) it launches the inference instance of the forward;
otherwise it goes through :class:`FusedLSTMFunction`, whose forward launches
the saving instance and whose backward launches the backward kernel. Only
CPU tensors take the plain PyTorch versions, :func:`lstm_reference` and
:func:`lstm_bwd_reference`, which have the same rounding points.
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

counter = LaunchCounter("fused_lstm")  # forward, inference instance
save_counter = LaunchCounter("fused_lstm_save")  # forward, saving residuals
bwd_counter = LaunchCounter("fused_lstm_bwd")


def _declare_fwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_lstm_fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dl4j_lstm_fwd.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_lstm_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dl4j_lstm_bwd.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = register_library(NativeLibrary("lstm_fwd.cu", _declare_fwd))
BWD_LIBRARY = register_library(NativeLibrary("lstm_bwd.cu", _declare_bwd))


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """What the plain versions compute in: fp32, or the input's dtype when
    that is wider (a float64 check against autograd)."""
    return torch.promote_types(dtype, torch.float32)


def lstm_reference(zx: torch.Tensor, w_rec: torch.Tensor,
                   peep: Optional[torch.Tensor], h0: torch.Tensor,
                   c0: torch.Tensor, mask: Optional[torch.Tensor], save: bool = False):
    """Plain time loop of the forward kernel's function (both cells): the
    same rounding points, one step at a time. Returns ``(ys, hT, cT)``, and
    with ``save`` also the residuals ``(gates, cseq)``."""
    hid = zx.shape[2] // 4
    dt = zx.dtype
    ct = _math_dtype(dt)
    w = w_rec.to(ct)
    p = None if peep is None else peep.to(ct)
    h = h0.to(ct)
    c = c0.to(ct)
    ys, gates, cseq = [], [], []
    for t in range(zx.shape[0]):
        z = zx[t].to(ct) + h.to(dt).to(ct) @ w
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
        o = torch.sigmoid(zo)
        h_til = o * torch.tanh(c_til)
        if mask is not None:
            m = mask[t].to(ct)[:, None]
            h_til = m * h_til + (1.0 - m) * h
            c_til = m * c_til + (1.0 - m) * c
        h, c = h_til, c_til
        ys.append(h.to(dt))
        if save:
            gates.append(torch.cat([i, f, g, o], dim=1).to(dt))
            cseq.append(c.to(dt))
    out = (torch.stack(ys), h.to(dt), c.to(dt))
    return out + (torch.stack(gates), torch.stack(cseq)) if save else out


def lstm_bwd_reference(dys: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                       gates: torch.Tensor, cseq: torch.Tensor, c0: torch.Tensor,
                       w_rec: torch.Tensor, peep: Optional[torch.Tensor],
                       mask: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain reverse-time loop of the backward kernel's function (both
    cells), with its rounding points: reads the residuals of
    :func:`lstm_reference` (``save=True``); returns ``(ds, dh0, dc0)`` in
    the input dtype."""
    hid = gates.shape[2] // 4
    dt = gates.dtype
    ct = _math_dtype(dt)
    w_t = w_rec.to(ct).t()
    p = None if peep is None else peep.to(ct)
    dh, dc = dhT.to(ct), dcT.to(ct)
    ds = [None] * gates.shape[0]
    for t in reversed(range(gates.shape[0])):
        g = gates[t].to(ct)
        i, f, gg, o = g[:, :hid], g[:, hid:2 * hid], g[:, 2 * hid:3 * hid], g[:, 3 * hid:]
        c_prev = (c0 if t == 0 else cseq[t - 1]).to(ct)
        tanh_c = torch.tanh(f * c_prev + i * gg)
        dh_tot = dh + dys[t].to(ct)
        dh_til, dc_til = dh_tot, dc
        if mask is not None:
            m = mask[t].to(ct)[:, None]
            dh_til, dc_til = m * dh_tot, m * dc
        d_o = dh_til * tanh_c * o * (1.0 - o)
        dc_til = dc_til + dh_til * o * (1.0 - tanh_c * tanh_c)
        if p is not None:
            dc_til = dc_til + d_o * p[2 * hid:]
        di = dc_til * gg * i * (1.0 - i)
        df = dc_til * c_prev * f * (1.0 - f)
        dg = dc_til * i * (1.0 - gg * gg)
        ds[t] = torch.cat([di, df, dg, d_o], dim=1).to(dt)
        dh_new = ds[t].to(ct) @ w_t
        dc_new = dc_til * f
        if p is not None:
            dc_new = dc_new + di * p[:hid] + df * p[hid:2 * hid]
        if mask is not None:
            dh_new = dh_new + (1.0 - m) * dh_tot
            dc_new = dc_new + (1.0 - m) * dc
        dh, dc = dh_new, dc_new
    return torch.stack(ds), dh.to(dt), dc.to(dt)


def lstm_param_grads(ds: torch.Tensor, ys: torch.Tensor, h0: torch.Tensor,
                     gates: torch.Tensor, cseq: torch.Tensor, c0: torch.Tensor,
                     w_rec: torch.Tensor, peep: Optional[torch.Tensor]):
    """The gradients the JAX package takes outside its backward kernel
    (``fused_lstm.py:297-304``, ``fused_lstm_graves.py:298-314``):
    ``dW_rec = h_prev^T @ ds`` over all (t, b), summed in fp32 and rounded
    to ``W_rec``'s dtype, and the three peephole reductions (``None``
    without peepholes)."""
    hid = ys.shape[2]
    ct = _math_dtype(ds.dtype)
    h_prev = torch.cat([h0[None], ys[:-1]], dim=0).reshape(-1, hid)
    dsf = ds.reshape(-1, 4 * hid).to(ct)
    dw = (h_prev.to(ct).t() @ dsf).to(w_rec.dtype)
    if peep is None:
        return dw, None
    ds3 = dsf.reshape(ds.shape)
    c_prev = torch.cat([c0[None], cseq[:-1]], dim=0).to(ct)
    g = gates.to(ct)
    c_til = g[..., hid:2 * hid] * c_prev + g[..., :hid] * g[..., 2 * hid:3 * hid]
    dpeep = torch.cat([(ds3[..., :hid] * c_prev).sum(dim=(0, 1)),
                       (ds3[..., hid:2 * hid] * c_prev).sum(dim=(0, 1)),
                       (ds3[..., 3 * hid:] * c_til).sum(dim=(0, 1))])
    return dw, dpeep.to(peep.dtype)


def fused_lstm_reference(zx, w_rec, h0, c0):
    """Plain PyTorch version of :func:`fused_lstm`'s forward."""
    return lstm_reference(zx, w_rec, None, h0, c0, None)


def _check_same(tensors, shapes, like) -> None:
    for name, tensor in tensors.items():
        if name in shapes and tuple(tensor.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(tensor.shape)}")
        if tensor.device != like.device:
            raise ValueError(f"{name} is on {tensor.device}, expected {like.device}")
        if tensor.dtype != like.dtype:
            raise TypeError(f"{name} is {tensor.dtype}, expected {like.dtype}")
    if like.device.type == "cpu":
        return
    if like.device.type != "cuda":
        raise ValueError(f"the recurrent kernels run on CUDA or CPU tensors, got {like.device}")
    if like.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {like.dtype}")
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(zx, w_rec, peep, h0, c0, mask) -> None:
    """Raise on anything the forward kernel does not take."""
    if zx.dim() != 3:
        raise ValueError(f"zx must be (T, B, 4H), got {tuple(zx.shape)}")
    t_len, b, h4 = zx.shape
    if h4 % 4 or t_len < 1 or b < 1 or h4 < 4:
        raise ValueError(f"zx must be (T, B, 4H) with T, B, H >= 1, got {tuple(zx.shape)}")
    hid = h4 // 4
    tensors = {"zx": zx, "w_rec": w_rec, "h0": h0, "c0": c0, "peep": peep, "mask": mask}
    shapes = {"w_rec": (hid, h4), "h0": (b, hid), "c0": (b, hid), "peep": (3 * hid,),
              "mask": (t_len, b)}
    _check_same({k: v for k, v in tensors.items() if v is not None}, shapes, zx)


def _check_bwd(dys, dhT, dcT, gates, cseq, c0, w_rec, peep, mask) -> None:
    """Raise on anything the backward kernel does not take."""
    if gates.dim() != 3 or gates.shape[2] % 4 or gates.shape[2] < 4:
        raise ValueError(f"gates must be (T, B, 4H), got {tuple(gates.shape)}")
    t_len, b, h4 = gates.shape
    hid = h4 // 4
    tensors = {"dys": dys, "dhT": dhT, "dcT": dcT, "gates": gates, "cseq": cseq,
               "c0": c0, "w_rec": w_rec, "peep": peep, "mask": mask}
    shapes = {"dys": (t_len, b, hid), "dhT": (b, hid), "dcT": (b, hid),
              "cseq": (t_len, b, hid), "c0": (b, hid), "w_rec": (hid, h4),
              "peep": (3 * hid,), "mask": (t_len, b)}
    _check_same({k: v for k, v in tensors.items() if v is not None}, shapes, gates)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_by_rows(lib, fn, args, b: int, launches: LaunchCounter, what: str,
                    like: torch.Tensor) -> None:
    """One launch of ``fn(*args, r0, rows, stream)`` per group of
    ``ROWS_PER_LAUNCH`` batch rows, on the current stream; raises on a
    refused launch."""
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        for r0 in range(0, b, ROWS_PER_LAUNCH):
            rows = min(ROWS_PER_LAUNCH, b - r0)
            err = fn(*args, r0, rows, stream)
            if err != 0:
                msg = lib.dl4j_cuda_error_string(err).decode()
                raise RuntimeError(f"{what} kernel launch failed: {msg} "
                                   f"(cudaError {err}) at shape {tuple(like.shape)} "
                                   f"{like.dtype}")
            launches.add()


def _counters(b: int, like: torch.Tensor) -> torch.Tensor:
    """The barrier scratch of the row-group kernels for one call: one zeroed
    int32 per batch row; the row group that starts at batch row r counts at
    ``counters[r]``, so no two groups of the call's launches share one."""
    return torch.zeros(b, dtype=torch.int32, device=like.device)


def launch_lstm_fwd(zx, w_rec, peep, h0, c0, mask, launches: LaunchCounter,
                    save: bool = False):
    """Launch the forward kernel on CUDA tensors already checked by
    :func:`_check`. Returns ``(ys, hT, cT)``; with ``save`` (the training
    instance) also the residuals ``(gates, cseq)``."""
    lib = LIBRARY.load()
    t_len, b, h4 = zx.shape
    hid = h4 // 4
    new = lambda *shape: torch.empty(shape, dtype=zx.dtype, device=zx.device)  # noqa: E731
    ys, h_t, c_t = new(t_len, b, hid), new(b, hid), new(b, hid)
    gates, cseq = (new(t_len, b, h4), new(t_len, b, hid)) if save else (None, None)
    counters = _counters(b, zx)
    args = (_DTYPE_CODES[zx.dtype], zx.data_ptr(), w_rec.data_ptr(), _ptr(peep),
            h0.data_ptr(), c0.data_ptr(), _ptr(mask), ys.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), _ptr(gates), _ptr(cseq), counters.data_ptr(), t_len, b, hid)
    _launch_by_rows(lib, lib.dl4j_lstm_fwd, args, b, launches, "LSTM forward", zx)
    return (ys, h_t, c_t, gates, cseq) if save else (ys, h_t, c_t)


def launch_lstm_bwd(dys, dhT, dcT, gates, cseq, c0, w_rec, peep, mask,
                    launches: LaunchCounter):
    """Launch the backward kernel on CUDA tensors already checked by
    :func:`_check_bwd`. Returns ``(ds, dh0, dc0)``."""
    lib = BWD_LIBRARY.load()
    t_len, b, h4 = gates.shape
    ds = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    counters = _counters(b, gates)
    args = (_DTYPE_CODES[gates.dtype], dys.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(), w_rec.data_ptr(), _ptr(peep),
            _ptr(mask), ds.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), counters.data_ptr(),
            t_len, b, h4 // 4)
    _launch_by_rows(lib, lib.dl4j_lstm_bwd, args, b, launches, "LSTM backward", gates)
    return ds, dh0, dc0


class FusedLSTMFunction(torch.autograd.Function):
    """Differentiable recurrence of both cells, the counterpart of the JAX
    ``custom_vjp`` (``fused_lstm.py:284-304``, ``fused_lstm_graves.py:285-315``).
    ``counters`` is the ``(save, backward)`` pair of launch counters of the
    calling wrapper. ``mask`` gets no gradient; with ``peep=None`` neither
    does ``peep``."""

    @staticmethod
    def forward(ctx, zx, w_rec, peep, h0, c0, mask, counters):
        if zx.device.type == "cpu":
            ys, h_t, c_t, gates, cseq = lstm_reference(zx, w_rec, peep, h0, c0, mask,
                                                       save=True)
        else:
            ys, h_t, c_t, gates, cseq = launch_lstm_fwd(zx, w_rec, peep, h0, c0, mask,
                                                        counters[0], save=True)
        ctx.save_for_backward(ys, gates, cseq, w_rec, peep, h0, c0, mask)
        ctx.bwd_counter = counters[1]
        return ys, h_t, c_t

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        ys, gates, cseq, w_rec, peep, h0, c0, mask = ctx.saved_tensors
        args = (dys.contiguous(), dhT.contiguous(), dcT.contiguous(), gates, cseq, c0,
                w_rec, peep, mask)
        _check_bwd(*args)
        if gates.device.type == "cpu":
            ds, dh0, dc0 = lstm_bwd_reference(*args)
        else:
            ds, dh0, dc0 = launch_lstm_bwd(*args, ctx.bwd_counter)
        dw, dpeep = lstm_param_grads(ds, ys, h0, gates, cseq, c0, w_rec, peep)
        return ds, dw, dpeep, dh0, dc0, None, None


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def fused_lstm(zx: torch.Tensor, w_rec: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the recurrence. ``zx`` is the hoisted input projection
    ``x @ W + b`` laid out (T, B, 4H); returns ``(ys, hT, cT)`` with ys
    (T, B, H), all in zx's dtype, differentiable in zx, w_rec, h0 and c0.
    CUDA tensors launch the kernels (or the call raises); CPU tensors take
    the plain versions."""
    _check(zx, w_rec, None, h0, c0, None)
    if needs_grad(zx, w_rec, h0, c0):
        return FusedLSTMFunction.apply(zx, w_rec, None, h0, c0, None,
                                       (save_counter, bwd_counter))
    if zx.device.type == "cpu":
        return fused_lstm_reference(zx, w_rec, h0, c0)
    return launch_lstm_fwd(zx, w_rec, None, h0, c0, None, counter)
