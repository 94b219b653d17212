"""Persistent fused LSTM with peepholes and a per-step mask (CUDA), forward
and backward.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_lstm_graves.py``
(``_graves_fwd``, the ``pallas_call`` at :146, and
``_graves_bwd_kernel_call`` at :241): the ``GravesLSTM`` cell, and DL4J's
masked-sequence semantics, where masked steps hold h/c and emit the held h.
With no peepholes it is the plain cell, so it also serves masked ``LSTM``
layers. The kernels are ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu``
(shared with :mod:`.fused_lstm`, switched by template flags); their notes
state the bounds and the designs. Gradients go through
:class:`~.fused_lstm.FusedLSTMFunction`, with the peephole gradient reduced
outside the backward kernel as at JAX ``fused_lstm_graves.py:305-314``.

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

``peep=None`` means zero peepholes (and no ``dpeep``) and ``mask=None`` an
all-ones mask; both compute the same values as the explicit zeros/ones, with
fewer loads. ``mask`` is not differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import LaunchCounter
from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import (FusedLSTMFunction,
                                                             _check,
                                                             launch_lstm_fwd,
                                                             lstm_reference,
                                                             needs_grad)

counter = LaunchCounter("fused_graves_lstm")  # forward, inference instance
save_counter = LaunchCounter("fused_graves_lstm_save")  # forward, saving residuals
bwd_counter = LaunchCounter("fused_graves_lstm_bwd")


def fused_graves_lstm_reference(zx, w_rec, peep, h0, c0, mask=None):
    """Plain PyTorch version of :func:`fused_graves_lstm`."""
    return lstm_reference(zx, w_rec, peep, h0, c0, mask)


def fused_graves_lstm(zx: torch.Tensor, w_rec: torch.Tensor,
                      peep: Optional[torch.Tensor], h0: torch.Tensor,
                      c0: torch.Tensor, mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peephole+masked recurrence. ``zx`` (T, B, 4H) hoisted input
    projection, ``peep`` (3H,), ``mask`` (T, B) with 1.0 = real step, all in
    zx's dtype. Returns ``(ys, hT, cT)``, differentiable in zx, w_rec, peep,
    h0 and c0. CUDA tensors launch the kernels (or the call raises); CPU
    tensors take the plain versions."""
    _check(zx, w_rec, peep, h0, c0, mask)
    if needs_grad(zx, w_rec, peep, h0, c0):
        return FusedLSTMFunction.apply(zx, w_rec, peep, h0, c0, mask,
                                       (save_counter, bwd_counter))
    if zx.device.type == "cpu":
        return fused_graves_lstm_reference(zx, w_rec, peep, h0, c0, mask)
    return launch_lstm_fwd(zx, w_rec, peep, h0, c0, mask, counter)
