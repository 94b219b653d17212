"""Post-training int8 quantization for the serving path.

Counterpart of ``deeplearning4j_tpu/serving/quantize.py``, in its archive
format member for member, so an archive quantized by either package
restores in the other:

- :func:`quantize_archive` quantizes a ``ModelSerializer`` archive offline:
  per-output-channel symmetric int8 weights (the registry's ``quantize``/
  ``dequantize`` ops), input scales calibrated over a representative batch
  set (each batch CRC-framed through the ``serving.quantize.calibrate``
  chaos point: corrupt or truncated calibration data refuses the deploy),
  and the ``<archive>.dtype_policy.json`` sidecar declaring the serving
  dtypes and the accuracy gate. Members: ``quantization.json`` (format
  ``dl4j-tpu-quant-v1``), ``qweights.npz`` (``q|``/``s|``/``f|`` keys),
  ``qstate.npz`` (``m|`` keys), keyed by the leaves' ``jax.tree_util
  .keystr`` strings (``['layer_0']['W']``), which :func:`_keystr` writes
  from the port's own trees.
- :class:`QuantizedModel` serves a quantized archive through the replica
  pool unchanged: it has the network internals the pool reads
  (``_params``/``_model_state``, ``_forward``/``_forward_all``, ``output``,
  ``conf``). With ``weight_residency="int8"`` the parameters hold
  ``{"__q__": int8, "__scale__": fp32}`` leaves, dequantized inside the
  captured graph as ``q.to(act) * scale.to(act)``, the JAX package's order.
  Request rows in the policy's exact int8 dtype are dequantized inside the
  graph too; every other dtype passes through, so mixed f32/int8 traffic
  coalesces apart by signature and replays separate graphs.
- :class:`AccuracyGate` is the quantized face of
  :class:`~.delivery.GoldenGate`: ``ModelRegistry.deploy_quantized`` runs it
  before the hot-swap, and a failure (:class:`AccuracyGateFailed`) leaves
  the f32 version serving.

``quantize_archive(..., calibration=None)`` calibrates no input: the policy
then quantizes no request rows (token ids, say, which are indices and never
int8 codes), and only the weights are int8.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import struct
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import chaos
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_paths
from deeplearning4j_tpu_torch.serving import delivery
from deeplearning4j_tpu_torch.serving.manifest import atomic_replace
from deeplearning4j_tpu_torch.serving.replica import _numpy

ArrayOrDict = Union[np.ndarray, Dict[str, np.ndarray]]

logger = logging.getLogger(__name__)

POLICY_SUFFIX = ".dtype_policy.json"
QUANT_MEMBER = "quantization.json"
_CONF = "configuration.json"
_META = "metadata.json"
_WEIGHTS = "qweights.npz"
_STATE = "qstate.npz"
_FORMAT = "dl4j-tpu-quant-v1"

#: input-spec key of single-array (MultiLayerNetwork-style) models
SINGLE = "__single__"

#: integer code ranges per quantized input dtype (int8 narrow-range
#: symmetric, uint8 asymmetric)
_CODE_RANGE = {"int8": (-127, 127), "uint8": (0, 255)}


class CalibrationError(RuntimeError):
    """Calibration data was unusable (corrupt, truncated, non-finite or
    empty): the quantization is refused and nothing is written."""


class AccuracyGateFailed(delivery.GateFailed):
    """A quantized deploy failed its declared accuracy gate; the previous
    (f32) version keeps serving. ``report`` carries the measured deltas."""


def policy_path(archive_path: str) -> str:
    """Where a quantized archive's dtype-policy sidecar lives."""
    return archive_path + POLICY_SUFFIX


def _dtype_name(dtype) -> str:
    """A numpy or torch dtype's name (``"int8"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


# =========================================================== dtype policy
@dataclasses.dataclass
class DtypePolicy:
    """Per-model (and per-bucket) serving dtype declaration (JAX ``:109``).

    ``inputs`` maps input name (``__single__`` for single-input models) to
    ``{"dtype", "scale", "zero_point", "symmetric"}``, the calibrated affine
    map clients quantize request rows with (:func:`quantize_requests`) and
    the served graph inverts. ``quantized_buckets=None`` pre-warms every
    bucket at the quantized dtype; a list restricts the pre-warm to those
    buckets. ``gate`` declares the accuracy bar of a deploy."""

    weight_dtype: str = "int8"
    activation_dtype: str = "auto"  # auto -> the environment's compute dtype
    weight_residency: str = "dequantized"  # or "int8" (dequantized in the graph)
    per_channel: bool = True
    symmetric: bool = True
    inputs: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    quantized_buckets: Optional[List[int]] = None
    gate: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"metric": "top1_agreement", "max_delta": 0.02})
    created_at: float = 0.0

    # ------------------------------------------------------------- queries
    def label(self) -> str:
        """Compact label for the ``serving_dtype_policy`` info gauge."""
        per = "per-channel" if self.per_channel else "per-tensor"
        ins = ",".join(sorted({str(s.get("dtype", "?"))
                               for s in self.inputs.values()})) or "none"
        return (f"w:{self.weight_dtype}:{per}:{self.weight_residency}"
                f"/act:{self.activation_dtype}/in:{ins}")

    def input_spec(self, name: Optional[str]) -> Optional[Dict[str, Any]]:
        return self.inputs.get(SINGLE if name is None else name)

    def is_quantized_dtype(self, dtype, name: Optional[str] = None) -> bool:
        spec = self.input_spec(name)
        return spec is not None and _dtype_name(dtype) == np.dtype(spec["dtype"]).name

    def is_quantized_request(self, x: ArrayOrDict) -> bool:
        """Whether a normalized request is quantized traffic (dict requests:
        every policy-covered input in the policy dtype)."""
        if isinstance(x, dict):
            covered = [k for k in x if k in self.inputs]
            return bool(covered) and all(self.is_quantized_dtype(x[k].dtype, k)
                                         for k in covered)
        return self.is_quantized_dtype(np.asarray(x).dtype)

    def buckets_for(self, buckets) -> List[int]:
        """Buckets pre-warmed at the quantized dtype."""
        if self.quantized_buckets is None:
            return list(buckets)
        allowed = {int(b) for b in self.quantized_buckets}
        return [b for b in buckets if int(b) in allowed]

    def quantized_zeros(self, example: ArrayOrDict) -> Optional[ArrayOrDict]:
        """Zeros shaped like ``example`` at the policy's quantized input
        dtype(s): what warm-up captures the quantized graphs from. ``None``
        when the policy quantizes no input."""
        if not self.inputs:
            return None
        if isinstance(example, dict):
            out = {}
            for k, v in example.items():
                spec = self.inputs.get(k)
                out[k] = np.zeros(v.shape, np.dtype(spec["dtype"]) if spec else v.dtype)
            return out
        spec = self.inputs.get(SINGLE)
        if spec is None:
            return None
        return np.zeros(np.asarray(example).shape, np.dtype(spec["dtype"]))

    def resolved_activation_dtype(self) -> torch.dtype:
        if self.activation_dtype == "auto":
            from deeplearning4j_tpu_torch.runtime.environment import get_environment
            return get_environment().compute_dtype
        from deeplearning4j_tpu_torch.autodiff.ops_registry import torch_dtype
        return torch_dtype(self.activation_dtype)

    # --------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        return {"format": _FORMAT,
                "weight_dtype": self.weight_dtype,
                "activation_dtype": self.activation_dtype,
                "weight_residency": self.weight_residency,
                "per_channel": self.per_channel,
                "symmetric": self.symmetric,
                "inputs": self.inputs,
                "quantized_buckets": self.quantized_buckets,
                "gate": self.gate,
                "created_at": self.created_at}

    @staticmethod
    def from_dict(d: dict) -> "DtypePolicy":
        if d.get("format") != _FORMAT:
            raise ValueError(f"not a dtype policy (format={d.get('format')!r}, "
                             f"expected {_FORMAT!r})")
        qb = d.get("quantized_buckets")
        return DtypePolicy(
            weight_dtype=str(d.get("weight_dtype", "int8")),
            activation_dtype=str(d.get("activation_dtype", "auto")),
            weight_residency=str(d.get("weight_residency", "dequantized")),
            per_channel=bool(d.get("per_channel", True)),
            symmetric=bool(d.get("symmetric", True)),
            inputs={str(k): dict(v) for k, v in (d.get("inputs") or {}).items()},
            quantized_buckets=None if qb is None else [int(b) for b in qb],
            gate=dict(d.get("gate") or {}),
            created_at=float(d.get("created_at", 0.0)))

    def save(self, path: str) -> None:
        """Atomic write (a crash never leaves a torn policy)."""
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(self.to_dict(), f, indent=2)
        atomic_replace(path, write, prefix=".dtype-policy-")

    @staticmethod
    def load(path: str) -> "DtypePolicy":
        with open(path) as f:
            return DtypePolicy.from_dict(json.load(f))

    @staticmethod
    def load_for_archive(archive_path: str) -> Optional["DtypePolicy"]:
        p = policy_path(archive_path)
        if not os.path.exists(p):
            return None
        try:
            return DtypePolicy.load(p)
        except Exception as e:
            logger.warning("ignoring unreadable dtype policy %s (%s: %s)",
                           p, type(e).__name__, e)
            return None


# =========================================================== calibration
def _through_calibration_chaos(arr: np.ndarray) -> np.ndarray:
    """One calibration batch through the ``serving.quantize.calibrate``
    chaos point with CRC framing: any injected corruption or truncation is
    a :class:`CalibrationError`. No copy when no controller is installed."""
    chaos.inject("serving.quantize.calibrate")
    if not chaos.active():
        return arr
    payload = np.ascontiguousarray(arr, np.float32).tobytes()
    framed = struct.pack("<I", zlib.crc32(payload)) + payload
    out = chaos.transform_bytes("serving.quantize.calibrate", framed)
    if out is framed:
        return arr
    if len(out) < 4:
        raise CalibrationError("calibration batch truncated below its CRC header")
    (crc,), body = struct.unpack("<I", out[:4]), out[4:]
    if len(body) != len(payload) or zlib.crc32(body) != crc:
        raise CalibrationError(
            "calibration batch failed its CRC check (corrupt or truncated calibration "
            "data) — quantization refused")
    return np.frombuffer(body, np.float32).reshape(arr.shape)


def _normalize_calibration(calibration, input_names: List[str]) -> Dict[str, List[np.ndarray]]:
    """Calibration input -> ``{input_name: [batches]}``: an array, a list of
    arrays, a dict (multi-input graphs) or an ``.npz`` path."""
    if isinstance(calibration, str):
        with np.load(calibration) as z:
            if input_names:
                calibration = {n: z[n] for n in input_names if n in z.files}
            else:
                calibration = [z[k] for k in z.files]
    if isinstance(calibration, dict):
        return {str(k): ([np.asarray(b) for b in v] if isinstance(v, (list, tuple))
                         else [np.asarray(v)])
                for k, v in calibration.items()}
    batches = ([np.asarray(b) for b in calibration] if isinstance(calibration, (list, tuple))
               else [np.asarray(calibration)])
    return {SINGLE: batches}


def calibrate_inputs(calibration, input_names: Optional[List[str]] = None,
                     dtype: str = "int8") -> Dict[str, Dict[str, Any]]:
    """Per-input affine quantization specs from a representative batch set
    (JAX ``:303``): int8 symmetric narrow-range (``scale = amax/127``), uint8
    asymmetric (``scale = (hi-lo)/255``). Empty, non-finite or corrupt data
    raises :class:`CalibrationError`."""
    if dtype not in _CODE_RANGE:
        raise ValueError(f"unsupported quantized input dtype {dtype!r}; "
                         f"have {sorted(_CODE_RANGE)}")
    named = _normalize_calibration(calibration, input_names or [])
    if input_names:
        missing = [n for n in input_names if n not in named]
        if missing:
            raise CalibrationError(f"no calibration data for input(s) {missing}")
    specs: Dict[str, Dict[str, Any]] = {}
    for name, batches in named.items():
        if not batches or any(b.size == 0 for b in batches):
            raise CalibrationError(f"empty calibration batch set for input {name!r}")
        lo = hi = None
        n_rows = 0
        for b in batches:
            b = _through_calibration_chaos(np.asarray(b, np.float32))
            if not np.isfinite(b).all():
                raise CalibrationError(f"non-finite values in calibration data for input "
                                       f"{name!r} — quantization refused")
            lo = b.min() if lo is None else min(lo, b.min())
            hi = b.max() if hi is None else max(hi, b.max())
            n_rows += b.shape[0]
        if dtype == "int8":
            amax = max(abs(float(lo)), abs(float(hi)), 1e-12)
            scale, zp = amax / 127.0, 0
        else:  # uint8 asymmetric; the range covers 0 so padding rows are exact
            lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
            scale = max((hi - lo) / 255.0, 1e-12)
            zp = int(np.clip(round(-lo / scale), 0, 255))
        if not np.isfinite(scale) or scale <= 0.0:
            raise CalibrationError(f"degenerate calibration scale {scale!r} for input "
                                   f"{name!r} — quantization refused")
        specs[name] = {"dtype": dtype, "scale": float(scale), "zero_point": int(zp),
                       "symmetric": dtype == "int8", "calibration_rows": int(n_rows)}
    return specs


def quantize_requests(x: ArrayOrDict, policy: DtypePolicy) -> ArrayOrDict:
    """Client-side request quantization: f32 rows -> the policy's quantized
    input dtype. Inputs without a spec pass through unchanged."""
    def one(name, a):
        spec = policy.input_spec(name)
        if spec is None:
            return np.asarray(a)
        lo, hi = _CODE_RANGE[spec["dtype"]]
        q = np.round(np.asarray(a, np.float32) / spec["scale"])
        return np.clip(q + spec["zero_point"], lo, hi).astype(spec["dtype"])
    if isinstance(x, dict):
        return {k: one(k, v) for k, v in x.items()}
    return one(None, x)


# ======================================================== weight quant
def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a dict/sequence key path."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _tree_items(tree) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in the JAX package's flatten order."""
    return [(_keystr(p), leaf) for p, leaf in zip(tree_paths(tree), tree_leaves(tree))]


def _tree_rebuild(template, by_key: Dict[str, Any], prefix=()):
    """``template``'s structure with each leaf looked up by its key string
    (a leaf may be a tensor or a quantized-leaf dict)."""
    if isinstance(template, dict):
        return {k: _tree_rebuild(v, by_key, prefix + (k,)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_tree_rebuild(v, by_key, prefix + (i,))
                              for i, v in enumerate(template))
    key = _keystr(prefix)
    if key not in by_key:
        raise ValueError(f"quantized archive is missing leaf {key!r}")
    return by_key[key]


def _quantizable(leaf: np.ndarray) -> bool:
    """Quantized per channel: floating leaves of rank >= 2 (dense, conv and
    embedding kernels). Biases, norms and scalars stay f32."""
    return leaf.ndim >= 2 and np.issubdtype(leaf.dtype, np.floating)


def quantize_weight(w, per_channel: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric narrow-range int8 codes and scale of one weight leaf through
    the registry's ``quantize`` op, per output channel along the last axis.
    The round trip's error is at most ``scale/2``."""
    from deeplearning4j_tpu_torch.autodiff.ops_registry import OPS
    w = np.asarray(_numpy(w), np.float32)
    if per_channel and w.ndim >= 2:
        amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
        axis = -1
    else:
        amax, axis = np.max(np.abs(w)), None
    scale = np.maximum(np.asarray(amax, np.float32) / 127.0, np.float32(1e-12))
    q = OPS["quantize"](torch.from_numpy(w), scale=scale, zero_point=0, dtype="int8",
                        axis=axis, narrow_range=True)
    return q.numpy(), np.asarray(scale, np.float32)


def dequantize_weight(q, scale) -> np.ndarray:
    from deeplearning4j_tpu_torch.autodiff.ops_registry import OPS
    axis = -1 if np.asarray(scale).ndim == 1 else None
    return OPS["dequantize"](torch.as_tensor(np.asarray(q)), scale=np.asarray(scale),
                             axis=axis).numpy()


# ===================================================== archive quantize
def quantize_archive(src: str, dst: str, calibration, *, input_dtype: str = "int8",
                     per_channel: bool = True, activation_dtype: str = "auto",
                     weight_residency: str = "dequantized", max_accuracy_delta: float = 0.02,
                     quantized_buckets: Optional[List[int]] = None
                     ) -> Tuple[DtypePolicy, Dict[str, Any]]:
    """Quantize a ``ModelSerializer`` archive offline (JAX ``:430``):
    per-channel int8 weights, calibrated input scales, and the
    ``<dst>.dtype_policy.json`` sidecar. The archive is written atomically
    after calibration succeeds, so a :class:`CalibrationError` leaves no
    archive and no policy. ``calibration=None`` quantizes no input. Returns
    ``(policy, report)``."""
    if weight_residency not in ("dequantized", "int8"):
        raise ValueError(f"weight_residency must be 'dequantized' or 'int8', got "
                         f"{weight_residency!r}")
    with zipfile.ZipFile(src) as zf:
        names = zf.namelist()
        if QUANT_MEMBER in names:
            raise ValueError(f"{src!r} is already a quantized archive")
        conf_json = zf.read(_CONF).decode()
        meta = json.loads(zf.read(_META).decode()) if _META in names else {}
    from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
    model = ModelSerializer.restore_model(src, device="cpu", load_updater=False)
    graph_inputs = list(getattr(model.conf, "inputs", []) or [])

    # calibration first: nothing is written unless it succeeds
    input_specs = ({} if calibration is None else
                   calibrate_inputs(calibration, graph_inputs or None, dtype=input_dtype))

    arrays: Dict[str, np.ndarray] = {}
    qmeta: Dict[str, Dict[str, Any]] = {}
    n_quant = n_total = 0
    f32_bytes = q_bytes = 0
    for key, leaf in _tree_items(model._params):
        a = _numpy(leaf)
        n_total += 1
        f32_bytes += a.nbytes
        if _quantizable(a):
            q, scale = quantize_weight(a, per_channel=per_channel)
            arrays["q|" + key] = q
            arrays["s|" + key] = scale
            qmeta[key] = {"dtype": "int8", "axis": -1, "per_channel": bool(scale.ndim == 1)}
            q_bytes += q.nbytes + scale.nbytes
            n_quant += 1
        else:
            arrays["f|" + key] = a.astype(np.float32)
            q_bytes += a.nbytes
    state_arrays = {"m|" + key: _numpy(leaf) for key, leaf in _tree_items(model._model_state)}

    policy = DtypePolicy(
        weight_dtype="int8", activation_dtype=activation_dtype,
        weight_residency=weight_residency, per_channel=per_channel, symmetric=True,
        inputs=input_specs, quantized_buckets=quantized_buckets,
        gate={"metric": "top1_agreement", "max_delta": float(max_accuracy_delta)},
        created_at=time.time())

    meta = dict(meta)
    meta["quantized"] = True

    def write_archive(tmp):
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(_CONF, conf_json)
            zf.writestr(_META, json.dumps(meta))
            zf.writestr(QUANT_MEMBER, json.dumps(
                {"format": _FORMAT, "leaves": qmeta, "policy": policy.to_dict()}))
            for member, payload in ((_WEIGHTS, arrays), (_STATE, state_arrays)):
                buf = io.BytesIO()
                np.savez(buf, **payload)
                zf.writestr(member, buf.getvalue())
    atomic_replace(dst, write_archive, prefix=".quant-", suffix=".zip")
    policy.save(policy_path(dst))
    report = {"weights_quantized": n_quant, "leaves_total": n_total,
              "params_bytes_f32": int(f32_bytes),
              "params_bytes_quantized": int(q_bytes),
              "archive_bytes_src": os.path.getsize(src),
              "archive_bytes_dst": os.path.getsize(dst),
              "inputs": {k: {kk: v[kk] for kk in ("dtype", "scale", "zero_point")}
                         for k, v in input_specs.items()}}
    return policy, report


# ======================================================= quantized model
def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and "__q__" in node


class QuantizedModel:
    """A quantized archive served as a model (JAX ``:531``). It has what the
    replica pool reads (``conf``, ``device``, ``_params``, ``_model_state``,
    ``_forward``/``_forward_all``, ``output``), so the batcher buckets its
    traffic, the pool captures its graphs and the registry hot-swaps it as
    it does an f32 network."""

    def __init__(self, base, params, model_state, policy: DtypePolicy):
        self.base = base
        self.conf = base.conf
        self.rng = base.rng
        self.device = base.device
        self.dtype_policy = policy
        self._graph_inputs = list(getattr(base.conf, "inputs", []) or [])
        self._params = params
        self._model_state = model_state

    def init(self) -> "QuantizedModel":
        return self  # restored whole; nothing to draw

    # ------------------------------------------------------------ restore
    @staticmethod
    def restore(path: str, device=None) -> "QuantizedModel":
        """Load a :func:`quantize_archive` output onto ``device`` (``cuda``
        unless the caller or the environment asks for the CPU). The embedded
        policy is authoritative; the sidecar is for tooling."""
        with zipfile.ZipFile(path) as zf:
            qinfo = json.loads(zf.read(QUANT_MEMBER).decode())
            conf_json = zf.read(_CONF).decode()
            meta = json.loads(zf.read(_META).decode()) if _META in zf.namelist() else {}
            with np.load(io.BytesIO(zf.read(_WEIGHTS))) as z:
                arrays = {k: z[k] for k in z.files}
            with np.load(io.BytesIO(zf.read(_STATE))) as z:
                state_arrays = {k: z[k] for k in z.files}
        policy = DtypePolicy.from_dict(qinfo["policy"])
        if meta.get("model_type") == "ComputationGraph":
            from deeplearning4j_tpu_torch.models.computation_graph import (
                ComputationGraph, ComputationGraphConfiguration)
            base = ComputationGraph(ComputationGraphConfiguration.from_json(conf_json),
                                    device=device).init()
        else:
            from deeplearning4j_tpu_torch.models.multi_layer_network import MultiLayerNetwork
            from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
            base = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                     device=device).init()
        dev = base.device
        act = policy.resolved_activation_dtype()

        def put(a, dtype=None):
            return torch.as_tensor(a).to(dev, dtype)

        by_key: Dict[str, Any] = {}
        for key, _ in _tree_items(base._params):
            if ("q|" + key) in arrays:
                q, s = arrays["q|" + key], arrays["s|" + key]
                if policy.weight_residency == "int8":
                    by_key[key] = {"__q__": put(q), "__scale__": put(s)}
                else:
                    w = dequantize_weight(q, s)
                    by_key[key] = put(w, act if act != torch.float32 else None)
            elif ("f|" + key) in arrays:
                by_key[key] = put(arrays["f|" + key])
            else:
                raise ValueError(f"quantized archive {path!r} is missing leaf {key!r}")
        params = _tree_rebuild(base._params, by_key)
        state = _tree_rebuild(base._model_state,
                              {key: put(state_arrays["m|" + key])
                               for key, _ in _tree_items(base._model_state)})
        # the drawn parameters go; the quantized ones serve
        base._params, base._model_state = None, state
        return QuantizedModel(base, params, state, policy)

    # ----------------------------------------------------------- plumbing
    def _serve_params(self, params):
        """Dequantize the int8-resident leaves to the activation dtype (a
        plain walk for ``dequantized`` residency)."""
        act = self.dtype_policy.resolved_activation_dtype()

        def walk(node):
            if _is_qleaf(node):
                return node["__q__"].to(act) * node["__scale__"].to(act)
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return node
        return walk(params)

    def _dequant_one(self, name: Optional[str], x: torch.Tensor) -> torch.Tensor:
        """Invert the calibrated input map for rows in the policy's exact
        wire dtype; every other dtype (floats, plain integer features)
        passes through untouched."""
        spec = self.dtype_policy.input_spec(name)
        if spec is None or _dtype_name(x.dtype) != np.dtype(spec["dtype"]).name:
            return x
        act = self.dtype_policy.resolved_activation_dtype()
        zp = spec.get("zero_point", 0)
        x = x.to(act)
        if zp:
            x = x - torch.full((), zp, dtype=act, device=x.device)
        return x * torch.full((), spec["scale"], dtype=act, device=x.device)

    # ------------------------------------------------------------ forward
    def _forward(self, params, model_state, x, *, training: bool = False, generator=None,
                 fmask=None, carries=None):
        return self.base._forward(self._serve_params(params), model_state,
                                  self._dequant_one(None, x), training=training,
                                  generator=generator, fmask=fmask, carries=carries)

    def _forward_all(self, params, model_state, inputs, *, training: bool = False,
                     generator=None, masks=None, carries=None):
        deq = {k: self._dequant_one(k, v) for k, v in inputs.items()}
        return self.base._forward_all(self._serve_params(params), model_state, deq,
                                      training=training, generator=generator, masks=masks,
                                      carries=carries)

    def _as_input(self, x) -> torch.Tensor:
        from deeplearning4j_tpu_torch.train.prefetch import as_device_tensor
        return as_device_tensor(x, self.device)

    def output(self, *xs, training: bool = False, mask=None):
        """Inference through this wrapper's forward (the gate, direct calls
        and the replicas share it)."""
        with torch.inference_mode():
            if self._graph_inputs:
                if len(xs) == 1 and isinstance(xs[0], dict):
                    inputs = dict(xs[0])
                else:
                    inputs = dict(zip(self._graph_inputs, xs))
                inputs = {n: self._as_input(v) for n, v in inputs.items()}
                acts, _, _ = self._forward_all(self._params, self._model_state, inputs)
                outs = [acts[o] for o in self.conf.outputs]
                return outs[0] if len(outs) == 1 else outs
            m = None if mask is None else self._as_input(mask)
            return self._forward(self._params, self._model_state, self._as_input(xs[0]),
                                 fmask=m)[0]


# ========================================================= accuracy gate
class AccuracyGate(delivery.GoldenGate):
    """The quantized-deploy bar: :class:`~.delivery.GoldenGate` with its
    own chaos point (``serving.quantize.gate``) and failure
    (:class:`AccuracyGateFailed`). The quantized side sees its inputs
    through the policy's request quantization."""

    chaos_point = "serving.quantize.gate"
    failure_exc = AccuracyGateFailed
