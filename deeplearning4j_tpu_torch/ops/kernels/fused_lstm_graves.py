"""Persistent fused LSTM forward with peepholes and a per-step mask (CUDA).

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_lstm_graves.py``
(``_graves_fwd``, the ``pallas_call`` at :146): the ``GravesLSTM`` cell, and
DL4J's masked-sequence semantics, where masked steps hold h/c and emit the
held h. With no peepholes it is the plain cell, so it also serves masked
``LSTM`` layers. The kernel is ``csrc/lstm_fwd.cu`` (shared with
:mod:`.fused_lstm`, switched by template flags); its note there states the
bound and the design.

Cell (gate order [i, f, g, o], peephole rows [p_i, p_f, p_o]):

    z   = zx_t + h @ W_rec
    i   = sigmoid(z_i + c * p_i)
    f   = sigmoid(z_f + c * p_f)
    g   = tanh(z_g)
    c~  = f * c + i * g
    o   = sigmoid(z_o + c~ * p_o)
    h~  = o * tanh(c~)
    h'  = m * h~ + (1-m) * h          (m: per-step mask, 1.0 when unmasked)
    c'  = m * c~ + (1-m) * c

``peep=None`` means zero peepholes and ``mask=None`` an all-ones mask; both
compute the same values as the explicit zeros/ones, with fewer loads. The
backward kernel (TPU kernel #2) comes with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import LaunchCounter
from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import (_check,
                                                             launch_lstm_fwd,
                                                             lstm_reference)

counter = LaunchCounter("fused_graves_lstm")


def fused_graves_lstm_reference(zx, w_rec, peep, h0, c0, mask=None):
    """Plain PyTorch version of :func:`fused_graves_lstm`."""
    return lstm_reference(zx, w_rec, peep, h0, c0, mask)


def fused_graves_lstm(zx: torch.Tensor, w_rec: torch.Tensor,
                      peep: Optional[torch.Tensor], h0: torch.Tensor,
                      c0: torch.Tensor, mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peephole+masked recurrence. ``zx`` (T, B, 4H) hoisted input
    projection, ``peep`` (3H,), ``mask`` (T, B) with 1.0 = real step, all in
    zx's dtype. Returns ``(ys, hT, cT)``. CUDA tensors launch the kernel (or
    the call raises); CPU tensors take :func:`fused_graves_lstm_reference`."""
    _check(zx, w_rec, peep, h0, c0, mask)
    if zx.device.type == "cpu":
        return fused_graves_lstm_reference(zx, w_rec, peep, h0, c0, mask)
    return launch_lstm_fwd(zx, w_rec, peep, h0, c0, mask, counter)
