"""Runtime configuration: device and dtype policy.

Counterpart of ``deeplearning4j_tpu/runtime/environment.py``. One
process-wide :class:`Environment`, settable programmatically or through
``DL4J_TPU_*`` environment variables, holds the dtype policy
(``default_dtype`` for parameters, ``compute_dtype`` for activations and
matmuls) and the device policy: ``cuda`` by default, the CPU only when the
caller asks for it with :meth:`Environment.set_device`. With no GPU and no
such request, :meth:`Environment.resolve_device` raises — the port never
carries on quietly on the CPU.

The training runtime's switches are those of the JAX package
(``environment.py:185-215`` there), read from the same variables:
``packed_state`` (``DL4J_TPU_PACKED_STATE=0`` turns it off),
``dispatch_unroll`` (``DL4J_TPU_DISPATCH_UNROLL``), ``aot_dispatch``
(``DL4J_TPU_AOT_DISPATCH=0``), the kernels' build cache
(``DL4J_TPU_COMPILE_CACHE``, :meth:`Environment.set_compile_cache`) and
``nan_panic`` (``DL4J_TPU_NAN_PANIC=1``), and ``remat_segments``
(``DL4J_TPU_REMAT=1``, :meth:`Environment.set_remat`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional, Union

import torch

_ENV_PREFIX = "DL4J_TPU_"

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JSON schema's spelling)."""
    return str(dtype).replace("torch.", "")


def coerce_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {dtype!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass
class Environment:
    """Process-wide runtime configuration.

    - ``default_dtype``: dtype of freshly initialised parameters
      (``float32``).
    - ``compute_dtype``: dtype activations and matmuls are cast to inside
      the forward pass; parameters stay ``default_dtype``.
    - ``device``: ``None`` means ``cuda``; ``"cpu"`` must be asked for.
    - ``packed_state``: the fit loops keep the small leaves of the training
      state in one flat buffer per dtype (:mod:`.state_packing`); on by
      default.
    - ``dispatch_unroll``: batches grouped into one dispatch by the three
      fit loops (``>= 1``; 1 = no grouping). On a CUDA device a group is one
      captured graph of K steps.
    - ``aot_dispatch``: the fit loops replay captured CUDA graphs
      (:class:`.compile_cache.AotCache`); on by default.
    - ``nan_panic``: a fit raises ``FloatingPointError`` at the first step
      whose loss is not finite (it reads each loss back, so it waits for
      the device every step).
    - ``cache_compiled``: the kernels' build directory when
      :meth:`set_compile_cache` moved it, else ``None`` (``_build/``).
    - ``remat_segments``: a training forward keeps only the activations at
      its single-tensor cut points (a ``ComputationGraph``'s, or every
      hidden layer's boundary in a ``MultiLayerNetwork``) and recomputes
      what lies between them in the backward pass
      (``torch.utils.checkpoint``): memory traded for recomputation (JAX
      ``environment.py:61-65``); off by default.
    """

    default_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    device: Optional[str] = None
    packed_state: bool = True
    dispatch_unroll: int = 1
    aot_dispatch: bool = True
    nan_panic: bool = False
    cache_compiled: Optional[str] = None
    remat_segments: bool = False

    def set_default_dtype(self, dtype) -> "Environment":
        self.default_dtype = coerce_dtype(dtype)
        return self

    def set_compute_dtype(self, dtype) -> "Environment":
        self.compute_dtype = coerce_dtype(dtype)
        return self

    def allow_bfloat16(self) -> "Environment":
        """Mixed precision: bf16 compute, parameters stay ``default_dtype``."""
        self.compute_dtype = torch.bfloat16
        return self

    def set_packed_state(self, enabled: bool = True) -> "Environment":
        self.packed_state = bool(enabled)
        return self

    def set_dispatch_unroll(self, k: int) -> "Environment":
        if int(k) < 1:
            raise ValueError("dispatch_unroll must be >= 1")
        self.dispatch_unroll = int(k)
        return self

    def set_aot_dispatch(self, enabled: bool = True) -> "Environment":
        self.aot_dispatch = bool(enabled)
        return self

    def set_remat(self, enabled: bool = True) -> "Environment":
        self.remat_segments = bool(enabled)
        return self

    def set_nan_panic(self, enabled: bool) -> "Environment":
        self.nan_panic = bool(enabled)
        return self

    def set_compile_cache(self, directory: str) -> "Environment":
        """Build the kernels under ``directory`` (keyed by framework; see
        :mod:`.compile_cache`), the builder form of
        ``DL4J_TPU_COMPILE_CACHE``."""
        from deeplearning4j_tpu_torch.runtime import compile_cache
        self.cache_compiled = compile_cache.enable(directory)
        return self

    def to_dict(self) -> dict:
        return {"default_dtype": dtype_name(self.default_dtype),
                "compute_dtype": dtype_name(self.compute_dtype),
                "device": self.device, "packed_state": self.packed_state,
                "dispatch_unroll": self.dispatch_unroll,
                "aot_dispatch": self.aot_dispatch, "nan_panic": self.nan_panic,
                "cache_compiled": self.cache_compiled,
                "remat_segments": self.remat_segments}

    def set_device(self, device: Optional[Union[str, torch.device]]) -> "Environment":
        """``"cuda"``/``"cuda:N"``, ``"cpu"``, or ``None`` for the default
        (``cuda``)."""
        if device is not None:
            dev = torch.device(device)
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"device must be cuda or cpu, got {device!r}")
            device = str(dev)
        self.device = device
        return self

    def resolve_device(self, device: Optional[Union[str, torch.device]] = None
                       ) -> torch.device:
        """The device an entry point runs on: the ``device`` argument if
        given, else the environment's; ``cuda`` when neither asks for
        anything. Raises when that is ``cuda`` and no GPU is visible."""
        dev = torch.device(device if device is not None else (self.device or "cuda"))
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "deeplearning4j_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; ask for the CPU explicitly with "
                "get_environment().set_device('cpu') or device='cpu'")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {dev}")
        return dev


_lock = threading.Lock()  # guards: _instance construction
_instance: Optional[Environment] = None


def get_environment() -> Environment:
    """The process-wide :class:`Environment`. The first call reads
    ``DL4J_TPU_DTYPE``, ``DL4J_TPU_COMPUTE_DTYPE``, ``DL4J_TPU_NAN_PANIC``,
    ``DL4J_TPU_PACKED_STATE``, ``DL4J_TPU_DISPATCH_UNROLL``,
    ``DL4J_TPU_AOT_DISPATCH``, ``DL4J_TPU_COMPILE_CACHE`` and
    ``DL4J_TPU_REMAT``."""
    global _instance
    with _lock:
        if _instance is None:
            env = Environment()
            if os.environ.get(_ENV_PREFIX + "DTYPE"):
                env.set_default_dtype(os.environ[_ENV_PREFIX + "DTYPE"])
            if os.environ.get(_ENV_PREFIX + "COMPUTE_DTYPE"):
                env.set_compute_dtype(os.environ[_ENV_PREFIX + "COMPUTE_DTYPE"])
            if os.environ.get(_ENV_PREFIX + "NAN_PANIC", "").lower() in ("1", "true"):
                env.nan_panic = True
            env.remat_segments = os.environ.get(
                _ENV_PREFIX + "REMAT", "").lower() in ("1", "true")
            if os.environ.get(_ENV_PREFIX + "PACKED_STATE", "").lower() in ("0", "false"):
                env.packed_state = False
            if os.environ.get(_ENV_PREFIX + "DISPATCH_UNROLL", "").isdigit():
                # "0" means no grouping, as in the JAX package
                env.set_dispatch_unroll(max(1, int(os.environ[_ENV_PREFIX + "DISPATCH_UNROLL"])))
            if os.environ.get(_ENV_PREFIX + "AOT_DISPATCH", "").lower() in ("0", "false"):
                env.aot_dispatch = False
            cache = os.environ.get(_ENV_PREFIX + "COMPILE_CACHE")
            if cache:
                from deeplearning4j_tpu_torch.runtime import compile_cache
                env.cache_compiled = compile_cache.enable(cache)
            _instance = env
        return _instance
