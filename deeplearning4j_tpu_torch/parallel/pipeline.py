"""GPipe-style pipeline parallelism over the ``pipe`` mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``: the
shift-register schedule of ``n_microbatches + n_stages - 1`` ticks. Stage
``s`` holds its parameters on the device at ``pipe = s``; at tick ``t`` it
runs microbatch ``t - s`` and hands its output to stage ``s + 1``'s device
(a copy) for the next tick. The JAX package runs the schedule inside one
``shard_map`` program with a ``ppermute`` a tick; here one process drives
the ticks, and the ticks that the JAX loop fills with clamped, discarded
inputs are skipped. Stages must be shape-preserving (the trunk of a
network).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.tensor_shards import TensorShards, to_device
from deeplearning4j_tpu_torch.runtime.mesh import PIPE_AXIS, Mesh
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map


def stack_stage_params(per_stage_params) -> Any:
    """``[stage0_tree, stage1_tree, ...]`` -> one tree with a leading stage
    dim."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in per_stage_params]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([t[i] for t in per_stage_params])
                           for i in range(len(first)))
    return torch.stack(list(per_stage_params))


def _n_stages(stacked) -> int:
    leaf = tree_leaves(stacked)[0]
    return len(leaf) if isinstance(leaf, TensorShards) else int(leaf.shape[0])


def _stage_tree(stacked, s: int, device):
    """Stage ``s``'s parameters on ``device``: a stacked tensor's slice
    copied there, or a stage-split :class:`TensorShards`' own piece (already
    on its stage's device)."""
    def pick(a):
        if isinstance(a, TensorShards):
            return a.pieces[s][0]
        return to_device(a[s], device)
    return tree_map(pick, stacked)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params: Any,
          x: torch.Tensor, *, mesh: Mesh, n_microbatches: int, axis_name: str = PIPE_AXIS,
          batch_axes: Optional[Sequence[str]] = None,
          at: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` applications of ``stage_fn`` pipelined
    over the mesh's ``axis_name`` (JAX ``:37``).

    ``stage_fn(stage_params, microbatch) -> microbatch`` (same shape);
    ``stacked_params``: every leaf has leading dim ``n_stages`` (or is a
    :class:`TensorShards` split in one piece per stage). ``batch_axes``:
    mesh axes the rows additionally split over, one pipeline per coordinate
    (rank order), the outputs concatenated; ``at``: the coordinate of the
    other axes this pipeline runs at. Returns the output on ``x``'s device.
    """
    at = dict(at or {})
    if batch_axes:
        coords = mesh.coords(batch_axes)
        n = len(coords)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} data coordinates")
        c = x.shape[0] // n
        outs = [gpipe(stage_fn, stacked_params, x.narrow(0, r * c, c), mesh=mesh,
                      n_microbatches=n_microbatches, axis_name=axis_name, at={**at, **coord})
                for r, coord in enumerate(coords)]
        return torch.cat([o.to(x.device) for o in outs])
    S = mesh.shape[axis_name]
    n_stages = _n_stages(stacked_params)
    if n_stages != S:
        raise ValueError(f"{n_stages} stages require a {axis_name}-axis of the same size, "
                         f"mesh has {S}")
    B = x.shape[0]
    M = int(n_microbatches)
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    devs = [mesh.device_at(**{**at, axis_name: s}) for s in range(S)]
    stages = [_stage_tree(stacked_params, s, devs[s]) for s in range(S)]
    outputs = [None] * M
    buf = [None] * S  # buf[s]: stage s's output of the last tick, on stage s + 1's device
    for t in range(M + S - 1):
        nxt = [None] * S
        for s in range(S):
            j = t - s
            if not 0 <= j < M:
                continue
            inp = to_device(x.narrow(0, j * mb, mb), devs[0]) if s == 0 else buf[s - 1]
            out = stage_fn(stages[s], inp)
            if s == S - 1:
                outputs[j] = out
            else:
                nxt[s] = to_device(out, devs[s + 1])
        buf = nxt
    return torch.cat([o.to(x.device) for o in outputs])


def sequential_reference(stage_fn, stacked_params, x):
    """Unpipelined oracle: the stages one after another on ``x``'s device."""
    for s in range(_n_stages(stacked_params)):
        x = stage_fn(tree_map(lambda a: a[s], stacked_params), x)
    return x
