"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``, plain
PyTorch as the JAX package's is plain jnp. The sequence is split into one
block per ring position (the device at ``seq = i``); each position keeps
its query block while the key/value blocks travel one position up the ring
a step (a copy to the next device), and a flash-style running softmax
(running max and denominator, in float32) accumulates the output. One
process drives the ring.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from deeplearning4j_tpu_torch.nn.tensor_shards import to_device
from deeplearning4j_tpu_torch.runtime.mesh import SEQ_AXIS, Mesh


def ring_attention(q_blocks: Sequence[torch.Tensor], k_blocks: Sequence[torch.Tensor],
                   v_blocks: Sequence[torch.Tensor], causal: bool = False) -> List[torch.Tensor]:
    """Blockwise ring attention (JAX ``:41``). ``q_blocks[i]`` etc. are the
    ``(batch, heads, t_local, d)`` blocks of ring position ``i``, each on
    its device; the full sequence is ``t_local * n`` long. ``causal`` masks
    by global position. Returns each position's output block, in q's
    dtype."""
    n = len(q_blocks)
    t_local = q_blocks[0].shape[2]
    d = q_blocks[0].shape[-1]
    scale = 1.0 / math.sqrt(d)
    q32 = [q.float() for q in q_blocks]
    o = [torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32, device=q.device)
         for q, v in zip(q_blocks, v_blocks)]
    m = [torch.full(q.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
         for q in q_blocks]
    l = [torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device) for q in q_blocks]
    kv = [(to_device(k, q.device), to_device(v, q.device))
          for q, k, v in zip(q_blocks, k_blocks, v_blocks)]
    for step in range(n):
        for i in range(n):
            k_blk, v_blk = kv[i]
            src = (i - step) % n  # the position whose block i holds now
            scores = torch.einsum("bhqd,bhkd->bhqk", q32[i], k_blk.float()) * scale
            if causal:
                dev = scores.device
                q_pos = i * t_local + torch.arange(t_local, device=dev)
                k_pos = src * t_local + torch.arange(t_local, device=dev)
                scores = scores.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), -math.inf)
            new_m = torch.maximum(m[i], scores.amax(dim=-1))
            safe_m = torch.where(torch.isfinite(new_m), new_m, torch.zeros_like(new_m))
            p = torch.exp(scores - safe_m[..., None])
            p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m[i]), torch.exp(m[i] - safe_m),
                               torch.zeros_like(m[i]))
            l[i] = l[i] * corr + p.sum(dim=-1)
            o[i] = o[i] * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
            m[i] = new_m
        # rotate: position i takes position i - 1's block
        kv = [tuple(to_device(t, q_blocks[i].device) for t in kv[(i - 1) % n])
              for i in range(n)]
    return [(oi / torch.clamp(li[..., None], min=1e-20)).to(q.dtype)
            for oi, li, q in zip(o, l, q_blocks)]


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                                causal: bool = False, seq_axis: str = SEQ_AXIS) -> torch.Tensor:
    """Global ``(batch, heads, T, d)`` q/k/v: the time axis split over
    ``seq_axis`` (block ``i`` copied to the device at ``seq = i``), ring
    attention per block, the output gathered back on q's device (JAX
    ``:96``)."""
    n = mesh.shape[seq_axis]
    T = q.shape[2]
    if T % n:
        raise ValueError(f"sequence of {T} does not split over a {seq_axis} axis of {n}")
    c = T // n
    devs = [mesh.device_at(**{seq_axis: i}) for i in range(n)]

    def blocks(t):
        return [to_device(t.narrow(2, i * c, c), devs[i]) for i in range(n)]

    outs = ring_attention(blocks(q), blocks(k), blocks(v), causal=causal)
    return torch.cat([o.to(q.device) for o in outs], dim=2)
