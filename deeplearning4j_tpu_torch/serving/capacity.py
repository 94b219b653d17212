"""Per-model capacity and resource accounting.

Counterpart of ``deeplearning4j_tpu/serving/capacity.py``: a reader over the
live serving objects (it owns no state and mutates nothing), so a capacity
scrape can run at any time without perturbing traffic.

- **Parameter bytes**: every leaf of the model's parameters and layer state,
  per dtype (an int8-resident quantized model shows its int8 codes).
- **Device bytes** (the number the registry's budget ledger holds): every
  distinct storage the served entry holds, by mesh position. That is each
  replica's copies (cast to the compute dtype as the replicas hold them)
  and, for an entry the registry restored from an archive, the restored
  model's own tensors where they sit on a CUDA device (the replicas copy
  them; the entry keeps them for ``served.model``). A live network's own
  tensors belong to its caller and are not counted, and neither is a model
  on the host. On the CPU in float32 the ledger therefore equals the JAX
  package's, which counts one copy per replica.
- **Positions**: a charge is keyed ``"<device>#<i>"``, ``i`` the position in
  the pool's device list, so a mesh that repeats ``cuda:0`` keeps one key
  per position (the budget holds each position, as the JAX package holds
  each device); :func:`served_physical_device_bytes` sums them per card.
- **Replica utilization**: (busy_s, window_s) pairs from the dispatch
  histogram, apportioned per replica by batch share.
- **Queue headroom** and the **captured graphs** (``compile_count``) plus
  the build cache's on-disk bytes.

:func:`render_prometheus` renders the JAX package's gauge names and text for
the same payload. ``runtime.profiler.capacity_stats()`` reads the attached
provider without a registry reference.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.runtime.trees import tree_leaves

__all__ = ["model_capacity", "process_capacity", "registry_capacity",
           "render_prometheus", "persistent_cache_bytes",
           "served_device_bytes", "served_device_dtype_bytes",
           "served_per_device_bytes", "served_physical_device_bytes",
           "attach_harvest", "detach_harvest", "device_utilization"]

# A background scheduler registers a zero-arg provider returning at least
# ``{"harvested_busy_s": float}``; one per process, so one module slot.
_HARVEST_PROVIDER = None


def attach_harvest(provider) -> None:
    """Register the process's background-harvest provider (``None`` or
    :func:`detach_harvest` clears it)."""
    global _HARVEST_PROVIDER
    _HARVEST_PROVIDER = provider


def detach_harvest() -> None:
    global _HARVEST_PROVIDER
    _HARVEST_PROVIDER = None


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def position_key(device, index: int) -> str:
    """The ledger key of position ``index`` of a pool's device list."""
    return f"{torch.device(device)}#{int(index)}"


def physical(key: str) -> str:
    """The card (device string) of a position key."""
    return key.split("#", 1)[0]


def _leaf_bytes(tree) -> Dict[str, int]:
    """Per-dtype byte totals over a tree of tensors (or arrays)."""
    out: Dict[str, int] = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            n, dt = leaf.numel() * leaf.element_size(), dtype_name(leaf.dtype)
        elif hasattr(leaf, "dtype") and hasattr(leaf, "nbytes"):
            n, dt = int(leaf.nbytes), str(leaf.dtype)
        else:
            continue
        out[dt] = out.get(dt, 0) + int(n)
    return out


def _charge(out: Dict[str, Dict[str, int]], key: str, t: torch.Tensor, seen: set) -> None:
    sid = (t.device, t.untyped_storage().data_ptr(), t.data_ptr(), t.numel())
    if sid in seen:
        return
    seen.add(sid)
    slot = out.setdefault(key, {})
    dt = dtype_name(t.dtype)
    slot[dt] = slot.get(dt, 0) + t.numel() * t.element_size()


def _served_device_map(served) -> Dict[str, Dict[str, int]]:
    """``position -> dtype -> bytes`` of every distinct storage the entry
    holds (see the module docstring)."""
    pool = served.batcher._pool
    out: Dict[str, Dict[str, int]] = {}
    seen: set = set()
    for rep in pool.live_replicas():
        if rep.params is None:
            # a pseudo-replica serving through the model's own output: its
            # state is what executes
            slot = out.setdefault(position_key(rep.device, 0), {})
            for part in (getattr(served.model, "_params", None),
                         getattr(served.model, "_model_state", None)):
                for dt, b in _leaf_bytes(part).items():
                    slot[dt] = slot.get(dt, 0) + b
            continue
        for key, t in rep.placed:
            _charge(out, key, t, seen)
    if getattr(served, "owns_model", False):
        model = served.model
        key = pool.position_of(getattr(model, "device", None))
        for part in (getattr(model, "_params", None), getattr(model, "_model_state", None)):
            for t in tree_leaves(part):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    _charge(out, key, t, seen)
    return out


def served_per_device_bytes(served) -> Dict[str, int]:
    """Per-position byte map of one served model: what each mesh position
    holds (a plan-sliced replica charges each position only its pieces).
    The per-position budget is held against this."""
    return {k: sum(v.values()) for k, v in _served_device_map(served).items()}


def served_physical_device_bytes(served) -> Dict[str, int]:
    """:func:`served_per_device_bytes` summed per card."""
    out: Dict[str, int] = {}
    for k, b in served_per_device_bytes(served).items():
        out[physical(k)] = out.get(physical(k), 0) + b
    return out


def served_device_bytes(served) -> int:
    """One served model's device bytes: the registry ledger's number."""
    return sum(served_device_dtype_bytes(served).values())


def served_device_dtype_bytes(served) -> Dict[str, int]:
    """Per-dtype breakdown of :func:`served_device_bytes` (what makes
    eviction scoring dtype-aware)."""
    out: Dict[str, int] = {}
    for dts in _served_device_map(served).values():
        for dt, b in dts.items():
            out[dt] = out.get(dt, 0) + b
    return out


def model_capacity(served) -> Dict[str, Any]:
    """One served model's resource accounting (JAX ``model_capacity``)."""
    batcher = served.batcher
    pool = batcher._pool
    metrics = served.metrics
    model = served.model
    param_dtype_bytes = _leaf_bytes(getattr(model, "_params", None))
    param_bytes = sum(param_dtype_bytes.values())
    state_bytes = sum(_leaf_bytes(getattr(model, "_model_state", None)).values())

    util = metrics.utilization_snapshot()
    window_s = max(1e-9, util["window_s"])
    busy_s = util["busy_s"]
    batches_total = max(0, util["batches_total"])
    replica_batches = util["replica_batches"]

    per_replica = []
    for rep in pool.live_replicas():
        if rep.params is not None:
            rb = sum(t.numel() * t.element_size() for _, t in rep.placed)
        else:
            rb = param_bytes + state_bytes
        share = replica_batches.get(rep.index, 0) / batches_total if batches_total else 0.0
        per_replica.append({
            "replica": rep.index,
            "device": str(rep.device),
            "bytes": rb,
            "batches": replica_batches.get(rep.index, 0),
            "busy_s": round(busy_s * share, 6),
            "busy_fraction": round(busy_s * share / window_s, 6),
        })

    queue_depth = batcher._queue.qsize()
    queue_limit = batcher.admission.queue_limit
    drain_ms = batcher._drain_ms_per_request()
    est_drain_ms = (batcher.admission.retry_after_ms(queue_depth, drain_ms)
                    if queue_depth > 0 else 0.0)
    return {
        "param_bytes": param_bytes,
        "param_dtype_bytes": param_dtype_bytes,
        "model_state_bytes": state_bytes,
        "replicas": len(pool),
        "device_bytes_total": served_device_bytes(served),
        "per_device_bytes": served_per_device_bytes(served),
        "per_replica": per_replica,
        "utilization": {
            # a (busy_s, window_s) pair: a fleet sums both and divides once
            "busy_s": round(busy_s, 6),
            "window_s": round(window_s, 3),
            "busy_fraction": round(busy_s / window_s, 6),
        },
        "queue": {
            "depth": queue_depth,
            "limit": queue_limit,
            "headroom_requests": max(0, queue_limit - queue_depth),
            "drain_ms_per_request": round(drain_ms, 4) if drain_ms is not None else None,
            "est_drain_ms": round(est_drain_ms, 2),
        },
        "aot_executables": batcher.compile_count(),
        "warmed_pairs": len(batcher._warmed_pairs),
        "buckets": list(batcher.buckets),
        "max_batch_size": batcher.max_batch_size,
        "dtype_policy": (batcher.dtype_policy.label()
                         if batcher.dtype_policy is not None else None),
        "dispatch_latency": util["dispatch_wire"],
        "version": served.version,
        "health": served.health.value,
    }


def persistent_cache_bytes() -> Optional[int]:
    """On-disk bytes of the build cache, or ``None`` when it is off (never
    raises: an unreadable entry drops out of the sum)."""
    from deeplearning4j_tpu_torch.runtime import compile_cache
    d = compile_cache.cache_dir()
    if d is None:
        return None
    total = 0
    try:
        for root, _, files in os.walk(d):
            for f in files:
                try:
                    total += os.stat(os.path.join(root, f)).st_size
                except OSError:
                    pass
    except OSError:
        return None
    return total


def process_capacity() -> Dict[str, Any]:
    """Process-level capacity: device memory (``bytes_limit`` = the card's
    total memory, ``bytes_in_use`` = ``torch.cuda.memory_allocated``, from
    ``runtime.profiler.device_memory_stats``; the CPU reports neither) and
    the build cache's footprint."""
    from deeplearning4j_tpu_torch.runtime import compile_cache, profiler
    devices = profiler.device_memory_stats()
    budget = in_use = None
    for stats in devices.values():
        limit = stats.get("bytes_limit")
        used = stats.get("bytes_in_use")
        if limit is not None:
            budget = (budget or 0) + int(limit)
        if used is not None:
            in_use = (in_use or 0) + int(used)
    cc = compile_cache.stats()
    return {
        "devices": devices,
        "device_budget_bytes": budget,
        "device_in_use_bytes": in_use,
        "compile_cache": {
            "enabled": bool(cc["enabled"]),
            "persistent_bytes": persistent_cache_bytes(),
            "hits": cc["hits"],
            "misses": cc["misses"],
            "aot_executables": cc["aot_compiles"],
        },
    }


def device_utilization(models: Dict[str, Any], harvested_busy_s: float = 0.0) -> Dict[str, Any]:
    """The worker-level busy window: the models' summable (busy_s,
    window_s) pairs in device-time terms and ``device_idle_fraction``
    (``harvested_busy_s`` from an attached scheduler joins the busy
    numerator)."""
    busy_s = sum(m["utilization"]["busy_s"] for m in models.values())
    device_window_s = sum(m["utilization"]["window_s"] * m["replicas"] for m in models.values())
    replicas = sum(m["replicas"] for m in models.values())
    if device_window_s > 0:
        serving_busy = busy_s / device_window_s
        idle = max(0.0, 1.0 - (busy_s + harvested_busy_s) / device_window_s)
    else:
        serving_busy, idle = 0.0, 1.0
    return {
        "busy_s": round(busy_s, 6),
        "harvested_busy_s": round(harvested_busy_s, 6),
        "device_window_s": round(device_window_s, 3),
        "replicas": replicas,
        "serving_busy_fraction": round(serving_busy, 6),
        "device_idle_fraction": round(idle, 6),
    }


def registry_capacity(registry) -> Dict[str, Any]:
    """The full capacity payload of one registry: per-model accounting, the
    process section, totals, utilization and, from a pager, the
    ``residency`` section."""
    models: Dict[str, Any] = {}
    for name in registry.names():
        try:
            models[name] = model_capacity(registry.get(name))
        except KeyError:
            pass  # cold, or undeployed between listing and snapshot
    harvested = 0.0
    harvest = None
    if _HARVEST_PROVIDER is not None:
        try:
            harvest = _HARVEST_PROVIDER()
            harvested = float(harvest.get("harvested_busy_s", 0.0))
        except Exception:
            harvest = None  # a dying scheduler must not break a scrape
    out = {
        "models": models,
        "process": process_capacity(),
        "totals": {
            "param_bytes": sum(m["param_bytes"] for m in models.values()),
            "device_bytes": sum(m["device_bytes_total"] for m in models.values()),
            "replicas": sum(m["replicas"] for m in models.values()),
        },
        "utilization": device_utilization(models, harvested_busy_s=harvested),
    }
    if harvest is not None:
        out["scheduler"] = harvest
    snap = getattr(registry, "residency_snapshot", None)
    if snap is not None:
        try:
            out["residency"] = snap()
        except Exception:
            pass  # the ledger must never break a scrape
    return out


def render_prometheus(payload: Dict[str, Any],
                      prefix: str = "capacity") -> str:
    """Render a :func:`registry_capacity` payload as Prometheus gauges: the
    JAX package's names and text for the same payload."""
    lines = [f"# TYPE {prefix}_param_bytes gauge"]
    for model, c in sorted((payload.get("models") or {}).items()):
        lbl = f'{{model="{model}"}}'
        lines.append(f"{prefix}_param_bytes{lbl} {c['param_bytes']}")
        lines.append(f"{prefix}_device_bytes{lbl} "
                     f"{c['device_bytes_total']}")
        lines.append(f"{prefix}_replicas{lbl} {c['replicas']}")
        lines.append(f"{prefix}_utilization_busy_fraction{lbl} "
                     f"{c['utilization']['busy_fraction']}")
        lines.append(f"{prefix}_queue_headroom_requests{lbl} "
                     f"{c['queue']['headroom_requests']}")
        lines.append(f"{prefix}_queue_est_drain_ms{lbl} "
                     f"{c['queue']['est_drain_ms']}")
        lines.append(f"{prefix}_aot_executables{lbl} "
                     f"{c['aot_executables']}")
        for dt, b in sorted(c["param_dtype_bytes"].items()):
            lines.append(f'{prefix}_param_dtype_bytes{{model="{model}",'
                         f'dtype="{dt}"}} {b}')
    util = payload.get("utilization")
    if util:
        # raw summable terms first, then the edge-derived fractions
        lines.append(f"{prefix}_device_busy_s {util['busy_s']}")
        lines.append(f"{prefix}_harvested_busy_s "
                     f"{util['harvested_busy_s']}")
        lines.append(f"{prefix}_device_window_s "
                     f"{util['device_window_s']}")
        lines.append(f"{prefix}_serving_busy_fraction "
                     f"{util['serving_busy_fraction']}")
        lines.append(f"{prefix}_device_idle_fraction "
                     f"{util['device_idle_fraction']}")
    proc = payload.get("process") or {}
    if proc.get("device_budget_bytes") is not None:
        lines.append(f"{prefix}_device_budget_bytes "
                     f"{proc['device_budget_bytes']}")
    if proc.get("device_in_use_bytes") is not None:
        lines.append(f"{prefix}_device_in_use_bytes "
                     f"{proc['device_in_use_bytes']}")
    cc = proc.get("compile_cache") or {}
    if cc.get("persistent_bytes") is not None:
        lines.append(f"{prefix}_compile_cache_bytes "
                     f"{cc['persistent_bytes']}")
    res = payload.get("residency")
    if res:
        # the pager's view: resident bytes vs budget, per-model residency
        # state, and the page-in/eviction counters
        if res.get("hbm_budget_bytes") is not None:
            lines.append(f"{prefix}_hbm_budget_bytes "
                         f"{res['hbm_budget_bytes']}")
        lines.append(f"{prefix}_resident_bytes "
                     f"{res.get('resident_bytes', 0)}")
        for model, m in sorted((res.get("models") or {}).items()):
            lines.append(f'{prefix}_model_resident{{model="{model}"}} '
                         f"{int(m.get('state') == 'resident')}")
            lines.append(f'{prefix}_model_bytes{{model="{model}"}} '
                         f"{m.get('bytes', 0)}")
        pg = res.get("paging") or {}
        for counter in ("page_ins_total", "evictions_total",
                        "page_in_queue_waits_total",
                        "page_in_rejections_total",
                        "page_in_failures_total",
                        "resident_hits_total", "cold_hits_total"):
            if counter in pg:
                lines.append(f"{prefix}_{counter} {pg[counter]}")
        for q, key in ((0.5, "page_in_p50_s"), (0.99, "page_in_p99_s")):
            if key in pg:
                lines.append(f'{prefix}_page_in_seconds{{quantile="{q}"}} '
                             f"{pg[key]}")
    return "\n".join(lines) + "\n"
