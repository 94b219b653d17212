"""Warmup manifests: the record that makes cold start replayable.

The port's own copy of ``deeplearning4j_tpu/serving/manifest.py``, with the
same JSON schema and dtype strings: a manifest written beside an archive by
either package replays in the other.

A warmed :class:`~.batcher.ContinuousBatcher` knows exactly which programs
its steady state needs: one captured CUDA graph per (bucket, replica,
dtype). That knowledge dies with the process, so every restart (and every
registry hot-swap) would rediscover it by capturing on live traffic. A
:class:`WarmupManifest` persists it as JSON next to the model archive
(``<archive>.warmup.json``):

- ``ModelRegistry.load`` finds the manifest and replays it — the batcher is
  constructed with the RECORDED bucket set (including buckets minted for
  oversized requests under the previous process's traffic) and warmed from
  the recorded input signature, so the model reaches READY having captured
  exactly the manifest's pairs and *nothing is captured on live traffic*.
- A registry hot-swap inherits the OLD entry's manifest automatically, so
  the replacement pre-warms the full live bucket set before taking
  traffic.

A missing, corrupt, or stale manifest is never fatal: the registry falls
back to the ordinary cold path (default buckets, warm-on-example or
capture-on-traffic) and writes a fresh manifest after warmup.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

ArrayOrDict = Union[np.ndarray, Dict[str, np.ndarray]]

logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".warmup.json"
_FORMAT = "dl4j-tpu-warmup-v1"

#: Key used for the single-array (MultiLayerNetwork-style) input signature.
_SINGLE = "__single__"


def manifest_path(archive_path: str) -> str:
    """Where a model archive's warmup manifest lives (next to it)."""
    return archive_path + MANIFEST_SUFFIX


def atomic_replace(path: str, writer, prefix: str = ".tmp-",
                   suffix: str = "") -> None:
    """Crash-safe file write shared by the serving sidecars (warmup
    manifests, dtype-policy sidecars, quantized archives): ``writer(tmp)``
    fills a temp file in the target's own directory (same filesystem, so
    the final ``os.replace`` is atomic — the discipline of
    ``train/checkpoint.py``), then the rename lands it; any failure
    unlinks the temp so a crash leaves either the old file or none,
    never a torn one."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=prefix, suffix=suffix, dir=d)
    os.close(fd)
    try:
        writer(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclasses.dataclass
class WarmupManifest:
    """Everything needed to rebuild a batcher's warm state offline.

    ``inputs`` maps input name (or ``__single__``) to
    ``{"shape_tail": [...], "dtype": "float32"}`` — the per-row feature
    signature warmup examples are built from. ``pairs`` is the audit
    record: every (bucket, replica, dtype) the recording batcher actually
    captured, the bound "captures on replay <= recorded pairs" is checked
    against.
    """

    inputs: Dict[str, Dict[str, object]]
    buckets: List[int]
    replicas: int
    pairs: List[Tuple[int, int, str]]
    max_batch_size: int = 0  # 0 = unrecorded (fall back to max bucket)
    model: str = ""
    created_at: float = 0.0
    #: serving dtype policy of the recording batcher — recorded
    #: so a restart's audit trail shows WHY int8 pairs appear in ``pairs``
    #: (the replayed warmup itself re-derives quantized variants from the
    #: model's own embedded policy, which stays authoritative)
    policy: Optional[dict] = None
    #: measured device bytes of the recording served model:
    #: lets a registry COLD-register this archive with an accurate HBM
    #: cost estimate without restoring it first (0 = unrecorded)
    device_bytes: int = 0
    #: measured page-in wall seconds: seeds the honest
    #: ``Retry-After`` estimate before this process has paged it in once
    page_in_s: float = 0.0
    #: ParallelPlan of the recording batcher (``ParallelPlan.describe()``):
    #: a plan-sliced warmup replayed under a DIFFERENT plan would mint
    #: different executables, so the replayer rebuilds the same slicing
    #: (or treats the manifest as cold)
    plan: Optional[dict] = None

    # ------------------------------------------------------------ construct
    @staticmethod
    def from_example(example: ArrayOrDict, buckets: List[int], replicas: int,
                     pairs: List[Tuple[int, int, str]],
                     max_batch_size: int = 0,
                     model: str = "",
                     policy: Optional[dict] = None,
                     plan: Optional[dict] = None) -> "WarmupManifest":
        if isinstance(example, dict):
            inputs = {str(k): {"shape_tail": list(v.shape[1:]),
                               "dtype": str(np.asarray(v).dtype)}
                      for k, v in example.items()}
        else:
            a = np.asarray(example)
            inputs = {_SINGLE: {"shape_tail": list(a.shape[1:]),
                                "dtype": str(a.dtype)}}
        return WarmupManifest(inputs=inputs,
                              buckets=sorted(int(b) for b in buckets),
                              replicas=int(replicas),
                              pairs=[(int(b), int(r), str(d))
                                     for b, r, d in pairs],
                              max_batch_size=int(max_batch_size),
                              model=model, created_at=time.time(),
                              policy=policy, plan=plan)

    def example(self, rows: int = 1) -> ArrayOrDict:
        """A ``rows``-row zeros warmup example matching the recorded input
        signature (zeros are what warmup uses anyway — only shape/dtype
        reach the capture)."""
        def zeros(spec):
            return np.zeros((rows,) + tuple(int(d) for d in
                                            spec["shape_tail"]),
                            np.dtype(str(spec["dtype"])))
        if set(self.inputs) == {_SINGLE}:
            return zeros(self.inputs[_SINGLE])
        return {name: zeros(spec) for name, spec in self.inputs.items()}

    # ----------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        d = {"format": _FORMAT, "model": self.model,
             "created_at": self.created_at, "inputs": self.inputs,
             "buckets": list(self.buckets), "replicas": self.replicas,
             "max_batch_size": self.max_batch_size,
             "pairs": [list(p) for p in self.pairs]}
        if self.policy is not None:
            d["policy"] = self.policy
        if self.plan is not None:
            d["plan"] = self.plan
        if self.device_bytes:
            d["device_bytes"] = int(self.device_bytes)
        if self.page_in_s:
            d["page_in_s"] = float(self.page_in_s)
        return d

    @staticmethod
    def from_dict(d: dict) -> "WarmupManifest":
        if d.get("format") != _FORMAT:
            raise ValueError(f"not a warmup manifest (format="
                             f"{d.get('format')!r}, expected {_FORMAT!r})")
        return WarmupManifest(
            inputs={str(k): dict(v) for k, v in d["inputs"].items()},
            buckets=[int(b) for b in d["buckets"]],
            replicas=int(d["replicas"]),
            pairs=[(int(b), int(r), str(dt)) for b, r, dt in
                   d.get("pairs", [])],
            max_batch_size=int(d.get("max_batch_size", 0)),
            model=str(d.get("model", "")),
            created_at=float(d.get("created_at", 0.0)),
            policy=d.get("policy"),
            device_bytes=int(d.get("device_bytes", 0)),
            page_in_s=float(d.get("page_in_s", 0.0)),
            plan=d.get("plan"))

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename) — a crash mid-save must leave either
        the old manifest or none, never a torn one (same discipline as
        ``train/checkpoint.py``)."""
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(self.to_dict(), f, indent=2)
        atomic_replace(path, write, prefix=".warmup-")

    @staticmethod
    def load(path: str) -> "WarmupManifest":
        with open(path) as f:
            return WarmupManifest.from_dict(json.load(f))

    @staticmethod
    def load_for_archive(archive_path: str) -> Optional["WarmupManifest"]:
        """The manifest recorded next to ``archive_path``, or ``None`` when
        absent or unreadable (a corrupt manifest only costs the cold path,
        it never fails a load)."""
        path = manifest_path(archive_path)
        if not os.path.exists(path):
            return None
        try:
            return WarmupManifest.load(path)
        except Exception as e:
            logger.warning("ignoring unreadable warmup manifest %s (%s: %s); "
                           "falling back to cold warmup", path,
                           type(e).__name__, e)
            return None
