"""Shared sequence helpers: which dtype recurrent carries start in.

Counterpart of ``deeplearning4j_tpu/models/_tbptt.py``; the truncated-BPTT
chunking rules come with training.
"""

from __future__ import annotations

import torch


def carry_dtype(sample, compute_dtype: torch.dtype) -> torch.dtype:
    """Recurrent carries start in the input dtype when it is floating (so a
    bf16 input stays bf16 through the recurrence), else the environment
    compute dtype."""
    if isinstance(sample, torch.Tensor) and sample.is_floating_point():
        return sample.dtype
    return compute_dtype
