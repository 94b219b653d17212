"""Shared truncated-BPTT helpers.

Counterpart of ``deeplearning4j_tpu/models/_tbptt.py``: what counts as a
sequence array, how a time window is sliced, and which dtype recurrent
carries start in.
"""

from __future__ import annotations

import torch


def is_sequence_array(v) -> bool:
    """(B, T, F) float features OR (B, T) integer token ids."""
    if not isinstance(v, torch.Tensor):
        return False
    return v.dim() == 3 or (v.dim() == 2 and not v.is_floating_point()
                            and not v.is_complex() and v.dtype != torch.bool)


def slice_time(v, t0: int, length: int):
    """Window [t0, t0+length) of a sequence array; non-sequence arrays pass
    through unchanged."""
    if is_sequence_array(v):
        return v[:, t0:t0 + length]
    return v


def carry_dtype(sample, compute_dtype: torch.dtype) -> torch.dtype:
    """Recurrent carries start in the input dtype when it is floating (so a
    bf16 input stays bf16 through the recurrence), else the environment
    compute dtype."""
    if isinstance(sample, torch.Tensor) and sample.is_floating_point():
        return sample.dtype
    return compute_dtype
