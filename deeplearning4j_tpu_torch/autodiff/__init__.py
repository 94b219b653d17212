"""Declarative autodiff graph API (SameDiff).

Counterpart of ``deeplearning4j_tpu.autodiff`` (reference
``org.nd4j.autodiff.samediff``): symbolic variables (VARIABLE / PLACEHOLDER
/ CONSTANT / ARRAY), op namespaces (``sd.math``, ``sd.nn``, ``sd.loss``,
...), training with ``sd.fit()``, save/load in the JAX package's archive,
and the graph optimizer's fusion passes. The graph runs eagerly in PyTorch,
op by op, with gradients from ``torch.autograd``.
"""

from deeplearning4j_tpu_torch.autodiff.samediff import SDVariable, SameDiff, TrainingConfig

__all__ = ["SameDiff", "SDVariable", "TrainingConfig"]
