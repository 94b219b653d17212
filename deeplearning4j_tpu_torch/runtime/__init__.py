"""Runtime substrate: environment, RNG, the kernels' build cache and
captured-graph dispatch, state packing, profiling, tracing, the event
journal, fault injection and meshes (counterpart of
``deeplearning4j_tpu.runtime``)."""

from deeplearning4j_tpu_torch.runtime import chaos, compile_cache, journal, trace
from deeplearning4j_tpu_torch.runtime.chaos import (
    AddLatency,
    ChaosCancelled,
    ChaosController,
    ChaosError,
    ChaosListener,
    CorruptBytes,
    FailNth,
    FailWithProbability,
    HangUntilCancelled,
)
from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
from deeplearning4j_tpu_torch.runtime.environment import Environment, get_environment
from deeplearning4j_tpu_torch.runtime.mesh import Mesh, MeshSpec, create_mesh
from deeplearning4j_tpu_torch.runtime.profiler import ExchangeStats, OpProfiler, ProfilerConfig
# as in the JAX package: the package-level name ``trace`` is the
# distributed-tracing module, the device-trace context manager is
# ``device_trace`` (``runtime.profiler.trace``)
from deeplearning4j_tpu_torch.runtime.profiler import trace as device_trace
from deeplearning4j_tpu_torch.runtime.rng import RngManager
from deeplearning4j_tpu_torch.runtime.state_packing import (GroupedDispatch, LeafPacker,
                                                            PackedStepLoop)

__all__ = [
    "trace",
    "journal",
    "device_trace",
    "chaos",
    "compile_cache",
    "ChaosController",
    "ChaosError",
    "ChaosCancelled",
    "ChaosListener",
    "FailNth",
    "FailWithProbability",
    "AddLatency",
    "CorruptBytes",
    "HangUntilCancelled",
    "Environment",
    "get_environment",
    "Mesh",
    "MeshSpec",
    "create_mesh",
    "RngManager",
    "OpProfiler",
    "ProfilerConfig",
    "ExchangeStats",
    "AotCache",
    "LeafPacker",
    "GroupedDispatch",
    "PackedStepLoop",
]
