"""Parameters held in pieces across a tensor-parallel group.

A tensor-parallel plan (``parallel/sharding.py``, the ``model`` axis) hands
a layer some of its weights as :class:`TensorShards`: the pieces of one
weight split along one dimension, piece ``j`` on the ``j``-th device of the
group. The attention and transformer layers (``nn/attention_layers.py``)
compute with the pieces where they lie (Megatron's column split of
``W_q``/``W_k``/``W_v``/``W_ff1`` and row split of ``W_o``/``W_ff2``) and
combine the partial products with :func:`rank_sum`: a copy to the home
device and a sum in the fixed order of the pieces, so a run is
deterministic whatever the devices are. Gradients flow back through the
copies under autograd.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class TensorShards:
    """One parameter as ``pieces`` split along ``dim``; piece ``j`` lives on
    device ``j`` of the group. Indexing the leading dimension (a stacked
    layer axis) indexes every piece."""

    __slots__ = ("pieces", "dim")

    def __init__(self, pieces: Sequence[torch.Tensor], dim: int):
        self.pieces: List[torch.Tensor] = list(pieces)
        self.dim = int(dim)

    def __len__(self) -> int:
        return len(self.pieces)

    def __getitem__(self, i) -> "TensorShards":
        if self.dim == 0:
            raise IndexError("cannot index the split dimension of a TensorShards")
        return TensorShards([p[i] for p in self.pieces], self.dim - 1)

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.pieces]

    def piece(self, j: int, dtype: torch.dtype) -> torch.Tensor:
        """Piece ``j`` in ``dtype`` (the compute dtype, as ``cast_floating``
        casts whole parameters)."""
        p = self.pieces[j]
        return p.to(dtype) if p.is_floating_point() and p.dtype != dtype else p


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` copied onto ``device``: a real copy even where the device is
    the same, so a mesh that repeats a device runs every hand-off."""
    return x.to(device, copy=True)


def rank_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of ``parts`` on ``device`` in their fixed order: the reduction of
    every plan (no collective whose order a backend chooses)."""
    acc = to_device(parts[0], device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc
