"""Devices and meshes.

Counterpart of ``deeplearning4j_tpu/runtime/mesh.py``. A :class:`Mesh` is
an n-dimensional array of ``torch.device`` s with named axes; the plans of
``parallel/sharding.py`` place parameter pieces, batch rows, pipeline
stages and sequence blocks on its positions, and one process drives them
all (a single-controller program, as ``ParallelWrapper(net, plan).fit`` is
one call in the JAX package). A device list may repeat a device: a mesh of
``["cuda:0"] * 2`` runs every copy, gather and fixed-order sum of a
two-device mesh on one card. Processes join only through
:func:`initialize_multihost` (``torch.distributed`` over gloo), which the
distributed trainer uses.

Mesh axis names (JAX ``:29-34``):

- ``data``   data parallelism (batch rows; single-axis FSDP shards its
  parameters over it too)
- ``fsdp``   parameter and optimizer-state sharding in a composed plan
- ``model``  tensor parallelism
- ``pipe``   pipeline stages
- ``seq``    sequence parallelism (ring attention)
- ``expert`` expert parallelism
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.environment import get_environment

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


def devices(backend: Optional[str] = None) -> List[torch.device]:
    """The devices of this process: every visible CUDA device, or the CPU
    when the caller asks for it (``backend="cpu"`` or
    ``get_environment().set_device("cpu")``). With no GPU and no such
    request this raises, as every entry point of the port does."""
    dev = get_environment().resolve_device(backend)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: ordered mapping of axis name -> size;
    ``-1`` on at most one axis means "whatever is left over"."""

    axes: Tuple[Tuple[str, int], ...]

    def __init__(self, axes: Union[Dict[str, int], Sequence[Tuple[str, int]]]):
        items = tuple(axes.items()) if isinstance(axes, dict) else tuple(axes)
        object.__setattr__(self, "axes", items)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("At most one mesh axis may be -1")
        fixed = int(np.prod([v for v in sizes.values() if v != -1])) if sizes else 1
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"Mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One machine of a multi-host bring-up (JAX ``:84``): ``name``, the
    ``address`` its processes are reached at, the ``spawn`` adapter
    (``"local"``, ``"loopback"``, or a remote transport) and a process-count
    hint (0 = unconstrained)."""

    name: str
    address: str = "127.0.0.1"
    spawn: str = "local"
    processes: int = 0


def loopback_hosts(n: int, prefix: str = "host") -> Tuple[HostSpec, ...]:
    """``n`` named loopback hosts: every host is this machine."""
    return tuple(HostSpec(name=f"{prefix}{i}", address="127.0.0.1", spawn="loopback")
                 for i in range(int(n)))


class Mesh:
    """Named axes over an array of devices (the role of
    ``jax.sharding.Mesh``). ``shape`` maps axis name -> size in axis
    order; :meth:`device_at` is the device at a coordinate (axes not named
    sit at 0)."""

    def __init__(self, devices_: np.ndarray, axis_names: Tuple[str, ...]):
        if devices_.ndim != len(axis_names):
            raise ValueError(f"{devices_.ndim}-d device array for axes {axis_names}")
        self.devices = devices_
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s) for a, s in zip(axis_names, devices_.shape)}

    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def device_at(self, **coords: int) -> torch.device:
        idx = tuple(int(coords.get(a, 0)) for a in self.axis_names)
        return self.devices[idx]

    def coords(self, axes: Sequence[str]) -> List[Dict[str, int]]:
        """Every coordinate over ``axes`` (those the mesh carries), the last
        axis fastest: the rank order of a gather over those axes."""
        present = [a for a in axes if a in self.shape]
        return [dict(zip(present, c))
                for c in itertools.product(*(range(self.shape[a]) for a in present))]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list()]})"


def create_mesh(spec: Union[MeshSpec, Dict[str, int], None] = None,
                devices_: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` from a :class:`MeshSpec` over ``devices_`` (default:
    :func:`devices`; pure data parallelism over all of them). The list may
    repeat a device. Its order is kept: neighbouring positions are
    neighbouring devices."""
    devs = [torch.device(d) for d in (devices_ if devices_ is not None else devices())]
    if spec is None:
        spec = MeshSpec({DATA_AXIS: -1})
    elif isinstance(spec, dict):
        spec = MeshSpec(spec)
    sizes = spec.resolve(len(devs))
    names = tuple(sizes.keys())
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(sizes[n] for n in names)), names)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         timeout_s: float = 300.0) -> None:
    """Join a process group (the JAX package's ``jax.distributed.initialize``
    with gloo CPU collectives, JAX ``:152``): ``torch.distributed`` over
    gloo, rendezvous at ``coordinator_address`` (``host:port``; default
    ``MASTER_ADDR``/``MASTER_PORT``), ``num_processes`` ranks (default
    ``WORLD_SIZE``), this one ``process_id`` (default ``RANK``). Gloo moves
    host tensors, so the group works whether the ranks compute on the CPU or
    on a card; two ranks may share one card."""
    import datetime

    import torch.distributed as dist
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{os.environ['MASTER_PORT']}")
    host, port = coordinator_address.rsplit(":", 1)
    os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, port
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    dist.init_process_group("gloo", init_method=f"tcp://{host}:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_multihost() -> None:
    """Leave the process group (a no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
