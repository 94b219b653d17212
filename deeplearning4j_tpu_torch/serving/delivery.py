"""The golden-set gate of gated delivery.

Counterpart of ``deeplearning4j_tpu/serving/delivery.py``'s gate half
(``:61-268``): :class:`GoldenGate`, the one deploy bar (the quantized
deploy's :class:`~.quantize.AccuracyGate` is a subclass), and
:class:`GoldenSet`, the declared evaluation set, persisted as a CRC-framed
``<archive>.golden`` sidecar in the JAX package's bytes. A sidecar that
fails its CRC is :class:`GateRefused`: a damaged bar refuses the deploy and
never passes it (chaos point ``serving.delivery.gate``).

The delivery half (``ShadowComparator``, ``DeliveryConfig``,
``DeliveryController`` and ``FeedbackLog``) drives the fleet router's staged
rollouts and comes with serving's host side.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.runtime import chaos

__all__ = ["GATE_POINT", "SHADOW_POINT", "GateFailed", "GateRefused", "GoldenGate",
           "GoldenSet"]

#: the golden-set gate's chaos point (call at every gate evaluation; byte
#: point over the CRC-framed golden-set sidecar)
GATE_POINT = "serving.delivery.gate"
#: the shadow mirror's chaos point (the delivery half fires it)
SHADOW_POINT = "serving.delivery.shadow"


class GateFailed(RuntimeError):
    """The candidate failed its golden-set gate; the incumbent keeps
    serving. ``report`` carries the measured deltas."""

    def __init__(self, msg: str, report: Optional[Dict[str, Any]] = None):
        super().__init__(msg)
        self.report = report or {}


class GateRefused(GateFailed):
    """The gate could not be trusted (corrupt or truncated golden set,
    unreadable sidecar): the deploy is refused exactly like a failed
    gate."""


def _probs(out) -> np.ndarray:
    """A model's (first) output as numpy, bfloat16 widened to float32."""
    from deeplearning4j_tpu_torch.serving.replica import _numpy
    if isinstance(out, (list, tuple)):
        out = out[0]
    return _numpy(out)


class GoldenSet:
    """The declared evaluation set a candidate must clear: inputs, optional
    labels (default: the golden model's own top-1, the **top-1 agreement**
    metric), and an optional ``max_delta``/``metric`` overriding the gate's
    bar. Persisted per archive as ``<archive>.golden``: a 4-byte
    little-endian CRC32 header and the JSON payload."""

    def __init__(self, inputs, labels=None, max_delta: Optional[float] = None,
                 metric: Optional[str] = None):
        self.inputs = np.asarray(inputs)
        self.labels = None if labels is None else np.asarray(labels)
        self.max_delta = None if max_delta is None else float(max_delta)
        self.metric = metric

    def gate(self, default: Optional["GoldenGate"] = None) -> "GoldenGate":
        """The gate this set declares: the sidecar's ``max_delta``/``metric``
        when present, else ``default`` (or the stock bar)."""
        base = default or GoldenGate()
        return GoldenGate(
            max_delta=self.max_delta if self.max_delta is not None else base.max_delta,
            metric=self.metric if self.metric is not None else base.metric)

    @staticmethod
    def sidecar(archive_path: str) -> str:
        return archive_path + ".golden"

    def save(self, path: str) -> str:
        payload = json.dumps({
            "inputs": self.inputs.tolist(),
            "labels": None if self.labels is None else self.labels.tolist(),
            "max_delta": self.max_delta,
            "metric": self.metric,
        }).encode()
        framed = struct.pack("<I", zlib.crc32(payload)) + payload
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(framed)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "GoldenSet":
        try:
            with open(path, "rb") as f:
                framed = f.read()
        except OSError as e:
            raise GateRefused(f"golden set {path!r} unreadable ({e}) — deploy refused")
        if len(framed) < 4:
            raise GateRefused(f"golden set {path!r} truncated below its CRC header — "
                              f"deploy refused")
        payload = chaos.transform_bytes(GATE_POINT, framed[4:])
        (crc,) = struct.unpack("<I", framed[:4])
        if zlib.crc32(payload) != crc:
            raise GateRefused(
                f"golden set {path!r} failed its CRC check (corrupt or truncated golden "
                f"set) — deploy refused, candidate never serves")
        try:
            obj = json.loads(payload.decode())
            return cls(obj["inputs"], labels=obj.get("labels"),
                       max_delta=obj.get("max_delta"), metric=obj.get("metric"))
        except Exception as e:
            raise GateRefused(f"golden set {path!r} unparsable after a clean CRC "
                              f"({e!r}) — deploy refused")

    @classmethod
    def for_archive(cls, archive_path: str) -> Optional["GoldenSet"]:
        """The archive's declared golden set, or ``None`` without a sidecar.
        A sidecar that exists but cannot be trusted is :class:`GateRefused`,
        never ``None``."""
        path = cls.sidecar(archive_path)
        if not os.path.exists(path):
            return None
        return cls.load(path)


class GoldenGate:
    """The deploy bar: the candidate's accuracy on the golden set may trail
    the golden model's by at most ``max_delta``. Without labels they
    default to the golden's own top-1 (**top-1 agreement**). A candidate
    with a ``dtype_policy`` sees its inputs through the policy's request
    quantization. ``golden_fn``/``candidate_fn`` override how each side
    produces probabilities (the registry routes both through their serving
    paths)."""

    #: subclasses re-point this at their own chaos point
    chaos_point = GATE_POINT
    #: the exception class a failed bar raises
    failure_exc = GateFailed

    def __init__(self, max_delta: float = 0.02, metric: str = "top1_agreement"):
        self.max_delta = float(max_delta)
        self.metric = metric

    @classmethod
    def from_policy(cls, policy) -> "GoldenGate":
        g = getattr(policy, "gate", None) or {}
        return cls(max_delta=float(g.get("max_delta", 0.02)),
                   metric=str(g.get("metric", "top1_agreement")))

    @staticmethod
    def _run(model, x):
        """One side's probabilities through ``model.output`` (graph models
        fed by input name)."""
        graph_inputs = list(getattr(getattr(model, "conf", None), "inputs", []) or [])
        if graph_inputs:
            if not isinstance(x, dict):
                x = {graph_inputs[0]: x}
            return _probs(model.output(*[x[n] for n in graph_inputs]))
        return _probs(model.output(x))

    def check(self, golden, candidate, inputs, labels=None,
              golden_fn: Optional[Callable[[Any], Any]] = None,
              candidate_fn: Optional[Callable[[Any], Any]] = None) -> Dict[str, Any]:
        """Evaluate both sides and enforce the bar: the report on success,
        :attr:`failure_exc` carrying it on failure."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        chaos.inject(self.chaos_point)
        golden_probs = _probs(golden_fn(inputs) if golden_fn is not None
                                else self._run(golden, inputs))
        if labels is None:
            labels = golden_probs.argmax(-1)
        labels = np.asarray(labels)
        policy = getattr(candidate, "dtype_policy", None)
        c_inputs = inputs
        if policy is not None and candidate_fn is None:
            from deeplearning4j_tpu_torch.serving.quantize import quantize_requests
            c_inputs = quantize_requests(inputs, policy)
        cand_probs = _probs(candidate_fn(c_inputs) if candidate_fn is not None
                              else self._run(candidate, c_inputs))
        ev_g, ev_c = Evaluation(), Evaluation()
        ev_g.eval(labels, golden_probs)
        ev_c.eval(labels, cand_probs)
        delta = ev_g.accuracy() - ev_c.accuracy()
        report = {"metric": self.metric,
                  "golden_accuracy": round(ev_g.accuracy(), 6),
                  "candidate_accuracy": round(ev_c.accuracy(), 6),
                  # the quantized deploy's report key, kept as the JAX package keeps it
                  "quantized_accuracy": round(ev_c.accuracy(), 6),
                  "accuracy_delta": round(float(delta), 6),
                  "max_delta": self.max_delta,
                  "n_examples": int(ev_g.total),
                  "passed": bool(delta <= self.max_delta)}
        if not report["passed"]:
            raise self.failure_exc(
                f"candidate failed its golden-set gate: delta {delta:.4f} > max_delta "
                f"{self.max_delta} (golden {report['golden_accuracy']}, candidate "
                f"{report['candidate_accuracy']} over {report['n_examples']} examples)",
                report)
        return report
