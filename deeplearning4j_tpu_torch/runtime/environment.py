"""Runtime configuration: device and dtype policy.

Counterpart of ``deeplearning4j_tpu/runtime/environment.py``. One
process-wide :class:`Environment`, settable programmatically or through
``DL4J_TPU_*`` environment variables, holds the dtype policy
(``default_dtype`` for parameters, ``compute_dtype`` for activations and
matmuls) and the device policy: ``cuda`` by default, the CPU only when the
caller asks for it with :meth:`Environment.set_device`. With no GPU and no
such request, :meth:`Environment.resolve_device` raises — the port never
carries on quietly on the CPU.
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
    """

    default_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    device: Optional[str] = None

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
    ``DL4J_TPU_DTYPE`` and ``DL4J_TPU_COMPUTE_DTYPE``."""
    global _instance
    with _lock:
        if _instance is None:
            env = Environment()
            if os.environ.get(_ENV_PREFIX + "DTYPE"):
                env.set_default_dtype(os.environ[_ENV_PREFIX + "DTYPE"])
            if os.environ.get(_ENV_PREFIX + "COMPUTE_DTYPE"):
                env.set_compute_dtype(os.environ[_ENV_PREFIX + "COMPUTE_DTYPE"])
            _instance = env
        return _instance
