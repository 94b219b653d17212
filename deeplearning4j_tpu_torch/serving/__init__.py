"""Model serving, core path (counterpart of ``deeplearning4j_tpu.serving``)."""

from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                      ServingError,
                                                      ServingShutdown,
                                                      default_buckets)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry, ServedModel

__all__ = ["ContinuousBatcher", "ModelRegistry", "ServedModel", "ServingError",
           "ServingShutdown", "default_buckets"]
