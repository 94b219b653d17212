"""Parallel and distributed training (counterpart of
``deeplearning4j_tpu.parallel``): :class:`ParallelPlan` and its placement
rules, :class:`ParallelWrapper` (one process driving a mesh: data, FSDP,
tensor and pipe plans), the GPipe schedule and its executor, ring attention
over the ``seq`` axis, and :class:`ParallelInference` (batched serving over
device replicas)."""

from deeplearning4j_tpu_torch.parallel.sharding import (
    ParallelPlan,
    PartitionSpec,
    ShardedTrainState,
    ShardingStrategy,
    shard_batch,
    shard_batch_tree,
    shard_train_state,
)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    ring_attention,
    sequence_parallel_attention,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    gpipe,
    sequential_reference,
    stack_stage_params,
)
from deeplearning4j_tpu_torch.parallel.plan_exec import PipePlanExecutor
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

__all__ = [
    "ParallelPlan",
    "PartitionSpec",
    "ShardingStrategy",
    "ShardedTrainState",
    "shard_batch",
    "shard_batch_tree",
    "shard_train_state",
    "ParallelWrapper",
    "ring_attention",
    "sequence_parallel_attention",
    "gpipe",
    "stack_stage_params",
    "sequential_reference",
    "PipePlanExecutor",
    "ParallelInference",
]
