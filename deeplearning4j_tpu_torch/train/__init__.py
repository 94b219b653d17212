"""Training engine: updaters, LR schedules, listeners, the overlapped feed
path, profiling, checkpoints, fault tolerance, early stopping, gradient
checks and the distributed trainer with threshold-encoded gradient sharing
(counterpart of ``deeplearning4j_tpu.train``; the line-search solvers are
not ported)."""

from deeplearning4j_tpu_torch.train.updaters import (
    AMSGrad,
    AdaDelta,
    AdaGrad,
    AdaMax,
    Adam,
    Nadam,
    Nesterovs,
    NoOp,
    RmsProp,
    Sgd,
    Updater,
)
from deeplearning4j_tpu_torch.train.schedules import (
    CycleSchedule,
    ExponentialSchedule,
    InverseSchedule,
    MapSchedule,
    PolySchedule,
    Schedule,
    SigmoidSchedule,
    StepSchedule,
)
from deeplearning4j_tpu_torch.train.listeners import (
    BaseTrainingListener,
    CollectScoresListener,
    EvaluativeListener,
    PerformanceListener,
    ScoreIterationListener,
    TrainingListener,
)
from deeplearning4j_tpu_torch.train.fault_tolerance import (
    FaultTolerantTrainer,
    HeartbeatMonitor,
    TrainingFailure,
)
from deeplearning4j_tpu_torch.train.prefetch import (
    AsyncLossDelivery,
    DevicePrefetcher,
    coerce_training_batch,
)
from deeplearning4j_tpu_torch.train.profiler import TrainingProfiler
from deeplearning4j_tpu_torch.train.early_stopping import (
    BestScoreEpochTerminationCondition,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.train.distributed import (
    DistributedConfig,
    DistributedSupervisor,
    DistributedTrainer,
    ExchangeError,
)

__all__ = [
    "DistributedConfig", "DistributedSupervisor", "DistributedTrainer", "ExchangeError",
    "FaultTolerantTrainer",
    "HeartbeatMonitor",
    "TrainingFailure",
    "DevicePrefetcher", "AsyncLossDelivery", "coerce_training_batch",
    "TrainingProfiler",
    "Updater", "Sgd", "Adam", "AdaMax", "AMSGrad", "Nadam", "Nesterovs",
    "RmsProp", "AdaGrad", "AdaDelta", "NoOp",
    "Schedule", "StepSchedule", "ExponentialSchedule", "InverseSchedule",
    "PolySchedule", "SigmoidSchedule", "MapSchedule", "CycleSchedule",
    "TrainingListener", "BaseTrainingListener", "ScoreIterationListener",
    "PerformanceListener", "EvaluativeListener", "CollectScoresListener",
    "EarlyStoppingConfiguration", "EarlyStoppingTrainer", "EarlyStoppingResult",
    "DataSetLossCalculator", "MaxEpochsTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition", "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
]
